"""`genmap-tpu-torch map` — compute mappability/frequency from an index.

Port of `genmap_tpu/cli/map_cmd.py` (itself mirroring GenMap
src/mappability.hpp:409-642): the same flag surface, overlap default and
clamp, output-path semantics, BED selection and per-file compute + output
loop, CSV locations (-d) and exclude-pseudo (-ep), plus `--device`.
Single- and multi-part indexes map on one device; the dimer rows are used
as the JAX CLI uses them (the engine's automatic policy, no flag).  In a
torch.distributed world (parallel/dist.py) every process computes the same
vectors and only rank 0 writes the output files.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from genmap_tpu_torch import tracing
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.fmindex import FMIndexData
from genmap_tpu_torch.io.bed import read_bed3
from genmap_tpu_torch.io.writers import (
    save_bedgraph,
    save_csv,
    save_raw,
    save_txt,
    save_wig,
)
from genmap_tpu_torch.ops.rank import resolve_device
from genmap_tpu_torch.parallel.dist import is_writer


def default_overlap(K: int, errors: int) -> int:
    """K-mer count searched at once, before the clamp.

    Reference formula (mappability.hpp:522-525): for E=0, K*0.7; otherwise
    K * min(max(K,30),100) * pow(0.7f, E) / 100.0 — note pow's float 0.7f
    promoted to double, and the final truncating unsigned conversion.
    """
    if errors == 0:
        return int(K * 0.7)
    factor = float(np.float32(0.7)) ** errors
    return int(K * min(max(K, 30), 100) * factor / 100.0)


def map_main(argv: list[str], report: dict | None = None, mesh=None) -> int:
    """Run `map`, in a `map.job` span.  When `report` is given it receives
    the engine's stats, the mapped k-mer count, the compute time, the
    device's resident bytes, the engine's calibrated pools and extension
    schedules, and `trace`: what the job added to the tracer's totals
    (`tracing.since`).  `mesh` (parallel/mesh.py; a Python argument, as the
    JAX CLI has no mesh option) maps on that mesh, every rank calling
    map_main alike."""
    snap = tracing.snapshot()
    with tracing.span("map.job"):
        rc = _map(argv, report, mesh, snap)
    if report is not None:
        report["trace"] = tracing.since(snap)
    return rc


def _map(argv: list[str], report: dict | None, mesh, snap) -> int:
    p = argparse.ArgumentParser(prog="genmap-tpu-torch map", add_help=True)
    p.add_argument("-I", "--index", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-E", "--errors", type=int, default=0)
    p.add_argument("-K", "--length", type=int, required=True)
    p.add_argument("-S", "--selection")
    p.add_argument("-nc", "--no-reverse-complement", action="store_true")
    p.add_argument("-ep", "--exclude-pseudo", action="store_true")
    p.add_argument("-fs", "--frequency-small", action="store_true")
    p.add_argument("-fl", "--frequency-large", action="store_true")
    p.add_argument("-r", "--raw", action="store_true")
    p.add_argument("-t", "--txt", action="store_true")
    p.add_argument("-w", "--wig", action="store_true")
    p.add_argument("-bg", "--bedgraph", action="store_true")
    p.add_argument("-b", "--bed", action="store_true")
    p.add_argument("-d", "--csv", action="store_true")
    p.add_argument("-m", "--memory-mapping", action="store_true")
    p.add_argument("-T", "--threads", type=int, default=0)  # accepted, unused
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-xo", "--overlap", type=int, default=None)
    p.add_argument("--batch-blocks", type=int, default=1024)
    p.add_argument("--batch-kmers", type=int, default=50000)
    p.add_argument("--device", default="cuda",
                   help="torch device to map on (default cuda; cpu runs the "
                        "plain PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    if not (args.wig or args.bedgraph or args.bed or args.raw or args.txt or args.csv):
        print("ERROR: Please choose at least one output format "
              "(i.e., --wig, --bedgraph, --bed, --raw, --txt, --csv).", file=sys.stderr)
        return 1
    if args.frequency_small and args.frequency_large:
        print("ERROR: Cannot use both --frequency-small and --frequency-large. "
              "Please choose one.", file=sys.stderr)
        return 1
    if args.errors > 4:
        print("E > 4 not yet supported.", file=sys.stderr)
        return 1
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    K = args.length
    errors = args.errors

    # overlap default + clamp (mappability.hpp:519-543)
    x = args.overlap if args.overlap is not None else default_overlap(K, errors)
    max_possible = min(K - 1, K - errors - 2)
    if x > max_possible:
        if args.overlap is not None:
            print(f"ERROR: overlap cannot be larger than min(K - 1, K - E - 2) = "
                  f"{max_possible}.", file=sys.stderr)
            return 1
        x = max_possible
    overlap = K - x  # length of the common overlap infix

    small = args.frequency_small
    mappability_out = not (args.frequency_small or args.frequency_large)
    cap = 255 if small else 65535

    with tracing.span("map.load_index"):
        data = FMIndexData.load(args.index, mmap=args.memory_mapping)
    if args.verbose:
        print(f"Index was loaded (dna{data.alphabet_size} alphabet, "
              f"sampling rate of {data.sampling}).")

    # output path semantics (mappability.hpp:562-619)
    out_path = args.output
    includes_filename = False
    if os.path.isdir(out_path):
        if not out_path.endswith("/"):
            out_path += "/"
    elif not data.directory:
        if out_path.endswith("."):
            out_path += "/"
        else:
            parent = os.path.dirname(out_path) or "."
            if not os.path.isdir(parent):
                print(f"ERROR: The output cannot be written to the file {out_path}.\n"
                      f"       It seems the directory {parent} does not exist.",
                      file=sys.stderr)
                return 1
            includes_filename = True
    else:
        print(f"ERROR: The output directory {out_path} does not exist.\n"
              "       A filename can only be specified for single indexed fasta "
              "files (not for indexed fasta directories).\n"
              "       Please create it, or choose a different location.", file=sys.stderr)
        return 1

    with tracing.span("map.engine_init"):
        engine = MappabilityEngine(
            data, batch_blocks=args.batch_blocks, batch_kmers=args.batch_kmers,
            # SA samples / locate are only read by the CSV and exclude-pseudo
            # paths; skipping their upload saves device memory
            light=not (args.csv or args.exclude_pseudo), device=device, mesh=mesh,
        )
    params = SearchParams(
        length=K,
        overlap=overlap,
        rev_compl=not args.no_reverse_complement,
        exclude_pseudo=args.exclude_pseudo,
    )

    selection = read_bed3(args.selection) if args.selection else None

    # fasta file boundaries for the csv columns (output.hpp:199-211)
    fasta_files: list[tuple[str, int]] = []
    for gi, fn in enumerate(data.seq_files):
        if not fasta_files or fasta_files[-1][0] != fn:
            fasta_files.append((fn, gi))
        else:
            fasta_files[-1] = (fn, gi)

    n_kmers = 0
    compute_start = time.time()
    total_files = len(engine.layouts)
    for file_no, layout in enumerate(engine.layouts, start=1):
        intervals = None
        csv_intervals = None
        if selection is not None:
            intervals = []
            csv_intervals = []
            for s, name in enumerate(layout.chrom_names):
                for begin, end in selection.get(name, []):
                    seq_len = int(layout.chrom_lens[s])
                    if begin >= seq_len or end > seq_len:
                        print("Error in BED file! Coordinates exceed sequence length: "
                              f'Seq. "{name}" has a length of {seq_len}, but '
                              f"half-closed interval [{begin}, {end}) given.",
                              file=sys.stderr)
                        return 1
                    cum = int(layout.cum_lens[s])
                    intervals.append((cum + begin, cum + end))
                    csv_intervals.append((s, begin, end))
            csv_intervals.sort()
            if not intervals:
                continue  # skip files without any selected interval

        with tracing.span("map.compute"):
            res = engine.compute_file(
                layout, params, errors, cap, intervals=intervals, csv=args.csv,
                file_no=file_no, total_files=total_files,
            )
        nk = max(0, layout.length - K + 1)
        if intervals is None:
            n_kmers += nk
        else:
            n_kmers += sum(max(0, min(e, nk) - b) for b, e in intervals)
        if not is_writer():
            continue

        path = out_path
        if not includes_filename:
            base = layout.name[: layout.name.rfind(".")] if "." in layout.name else layout.name
            path = out_path + base + ".genmap"

        def timed(label, fn, *a):
            with tracing.span("map.write." + label.lower()) as sp:
                fn(*a)
            if args.verbose:
                print(f"- {label} file written in "
                      f"{round(sp.ns / 1e7) / 100.0} seconds")

        if args.raw:
            ext = ".map" if mappability_out else (".freq8" if small else ".freq16")
            timed("RAW", save_raw, res.c, path + ext, mappability_out, small)
        if args.txt:
            timed("TXT", save_txt, res.c, path + ".txt", layout.chrom_names,
                  layout.chrom_lens, mappability_out)
        if args.wig:
            timed("WIG", save_wig, res.c, path, layout.chrom_names,
                  layout.chrom_lens, mappability_out)
        if args.bedgraph:
            timed("bedgraph", save_bedgraph, res.c, path, layout.chrom_names,
                  layout.chrom_lens, True, mappability_out)
        if args.bed:
            timed("BED", save_bedgraph, res.c, path, layout.chrom_names,
                  layout.chrom_lens, False, mappability_out)
        if args.csv:
            timed("CSV", save_csv, path, res.locations, params.rev_compl,
                  fasta_files, csv_intervals)
    st = engine.stats
    spans = tracing.since(snap)["spans"]
    compute_s = spans.get("map.compute", {}).get("s", 0.0)
    if args.verbose:
        print("Mappability computed in "
              f"{round((time.time() - compute_start) * 100.0) / 100.0} seconds")
        print(f"- engine: {st['batches']} batches "
              f"(dispatch {st['dispatch_s']:.2f}s, wait {st['fetch_s']:.2f}s, "
              f"scatter {st['scatter_s']:.2f}s, "
              f"dedup {tracing.seconds(spans, ['engine.dedup'], 'self_s'):.2f}s, "
              f"orchestrator {tracing.seconds(spans, tracing.ORCHESTRATOR, 'self_s'):.2f}s), "
              f"{st['overflow_blocks']} blocks escalated "
              f"(max tier {st['max_tier']})")
    if report is not None:
        report.update(
            stats=dict(st), n_kmers=n_kmers, compute_s=compute_s,
            resident_bytes=engine.resident_bytes(), device=str(engine.device),
            part_bytes=[ix.resident_bytes() for ix in engine.resident_indices()],
            tuned_pools=dict(engine._tuned_pools), ext_sched=dict(engine._ext_sched),
        )
    return 0
