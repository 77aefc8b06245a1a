"""Measure what an hg38-scale index build needs on this host.

    python -m genmap_tpu_torch.scripts.build_probe [--mbp 50 400] [--gbp 3.1]
        [--caps 4294967292 2500000000] [--out DIR]

Prints the host (CPUs and their model, MemAvailable, free disk under
`--out`), `hg38_demo`'s preflight at `--gbp` for each cap on the part size
(it prints the plan even when it would raise), then, for each `--mbp`, one
index build of a uniform random genome of that many bases in 24
hg38-proportioned chromosomes (`hg38_demo.make_genome`, one part), each in a
process of its own: its wall seconds, the seconds spent in each build
stage, both-strand symbols per second and the process's peak resident bytes per symbol
(`ru_maxrss`).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time


def child(mbp: float) -> None:
    """One timed build, in this process; prints one JSON line."""
    from genmap_tpu_torch.hostmem import retain_heap

    retain_heap()
    from genmap_tpu_torch.index import build
    from genmap_tpu_torch.io.fasta import FastaFile
    from genmap_tpu_torch.scripts.hg38_demo import make_genome

    t = time.perf_counter()
    seqs, _ = make_genome(mbp / 1e3, 30)
    gen_s = time.perf_counter() - t
    from genmap_tpu_torch.index import fmindex

    secs: dict = {}

    def timed(mod, name):
        inner = getattr(mod, name)

        def run(*a, **k):
            t0 = time.perf_counter()
            r = inner(*a, **k)
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
            return r

        setattr(mod, name, run)

    for name in ("suffix_array", "build_rank_rows", "_bitvec_rank_rows", "_pack_text",
                 "_make_ctext"):
        timed(build, name)
    timed(fmindex, "build_dimer_rows")
    ff = FastaFile(name="probe.fa")
    ff.ids = [f"chr{i + 1}" for i in range(len(seqs))]
    ff.seqs = seqs
    t = time.perf_counter()
    data = build.build_index([ff], sampling=10)
    wall = time.perf_counter() - t
    n = sum(p.n_total for p in data.parts)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(json.dumps(dict(mbp=mbp, symbols=n, parts=len(data.parts), gen_s=gen_s,
                          build_s=wall, symbols_per_s=n / wall, seconds_in=secs,
                          sais_symbols_per_s=n / secs["suffix_array"], peak_rss=peak,
                          peak_bytes_per_symbol=peak / n)), flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m genmap_tpu_torch.scripts.build_probe")
    p.add_argument("--mbp", type=float, nargs="*", default=[50.0, 400.0])
    p.add_argument("--gbp", type=float, default=3.1)
    p.add_argument("--caps", type=int, nargs="*", default=[2**32 - 4, 2_500_000_000])
    p.add_argument("--workers", type=int, nargs="*", default=[1, 2, 3])
    p.add_argument("--out", default=os.path.expanduser("~/.cache/genmap_tpu_torch/build_probe"))
    p.add_argument("--child", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child is not None:
        child(args.child)
        return 0

    from genmap_tpu_torch.scripts import hg38_demo

    lens = hg38_demo.chrom_lengths(args.gbp)
    for cap in args.caps:
        for w in args.workers:
            print(f"# preflight --gbp {args.gbp:g} --max-part-symbols {cap} --workers {w}",
                  flush=True)
            try:
                hg38_demo.preflight(lens, cap, w, args.out, 28.0)
            except RuntimeError as e:
                print(f"# {e}", flush=True)
    for mbp in args.mbp:
        r = subprocess.run([sys.executable, "-m", "genmap_tpu_torch.scripts.build_probe",
                            "--child", str(mbp)], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr[-3000:], flush=True)
            return 1
        print("# build " + r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
