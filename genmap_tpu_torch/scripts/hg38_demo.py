"""hg38-scale end-to-end run of genmap_tpu_torch: build a 3.1 Gbp two-part
index, map a chr21-sized selection at (30,2) on the card, and check planted
k-mers of known count and location.

    python -m genmap_tpu_torch.scripts.hg38_demo [--gbp 3.1] [--out DIR] [--k 30]
        [--errors 2] [--skip-build] [--batch-blocks 16384] [--device cuda]
        [--max-part-symbols N] [--workers 2] [--bytes-per-symbol 28] [--slice 200000]

The port's counterpart of the JAX package's `scripts/hg38_demo.py`.  The
genome is the same, byte for byte, for a given `--gbp` and `--k`: hg38's
24 chromosome lengths scaled to `--gbp`, uniform random bases from
`np.random.default_rng(42)`, and 50 planted K-mer families (1-4 exact,
0-3 one-mismatch and 0-3 two-mismatch copies each), drawn by the same calls
in the same order.  At K = 30 a random Hamming <= 2 neighbour anywhere in
6.2e9 positions has probability ~2e-5, so each planted site's frequency is
the family's copy count and its locations are the family's copies.

Stages, each timed and printed:

  * preflight: MemAvailable, CPU count and free disk under `--out`; the
    planned partition (whole chromosomes, greedy, `--max-part-symbols` the
    copy of `index -xm`); the RAM the largest `--workers` concurrent part
    builds need at `--bytes-per-symbol` (28: the SA-IS peak's upper end,
    README) and the disk the index takes; whether a part reaches 2^31
    symbols (such a part has no dimer rows).  It raises when RAM or disk is
    short; it never shrinks the run.
  * gen, index (`build_index(sampling=10)`, `save`, `FMIndexData.load(mmap=True)`;
    at least 2 parts), each part's symbols, `seq_off` and dimer rows;
  * map (light engine): the chr21 selection (sequence 20) at (K,E) with
    `x = min(default_overlap, K-1, K-E-2)`; the planted sites inside it; a
    one-position map of each family's first exact site; overlap invariance
    on a `--slice`-k-mer slice with the overlap moved by 3; wig and bedgraph
    of the chr21 slice;
  * locate (a second engine, `light=False`): the 50 first exact sites mapped
    with locations (the `-d` path); each family's located forward sites must
    equal its planted copies, exact and variants, with no reverse-strand
    site, and each frequency its copy count.

Per map: compute seconds and k-mers/s (engine constructed beforehand, so
the upload is excluded), the route, launches per kernel (counters set to 0
just before), each part's resident bytes and `torch.cuda.max_memory_allocated`.
`summary.json` under `--out` holds every record (and the sha256 of the chr21
slice's uint32 frequencies); the last line is `[done]` and the summary.  The
exit code is non-zero on any mismatch and on any failed stage.  The device is cuda unless `--device cpu` (the kernels' plain
versions); without a card it raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np

from genmap_tpu_torch.scripts.realistic_crosscheck import gpu_line, route

# hg38 chromosome lengths (Mbp, GRCh38 primary assembly, rounded)
HG38_MBP = [248.9, 242.2, 198.3, 190.2, 181.5, 170.8, 159.3, 145.1, 138.4,
            133.8, 135.1, 133.3, 114.4, 107.0, 102.0, 90.3, 83.3, 80.4,
            58.6, 64.4, 46.7, 50.8, 156.0, 57.2]
SEED = 42
FAMILIES = 50
CHR21 = 20  # "chr21" of the synthetic genome: sequence index 20
CAP = 65535
# on-disk index bytes per both-strand symbol at sampling 10, Dna4: rank rows
# 0.41, sampled SA 0.80, strand and indicator rows 0.31; dimer rows 2.00 more;
# the packed text 0.125 (a 3 Mbp two-part build's files)
INDEX_B_MONO = 1.52
INDEX_B_DIMER = 2.00
INDEX_B_TEXT = 0.125


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


# ---- genome ------------------------------------------------------------------

def chrom_lengths(gbp: float) -> list[int]:
    total = int(gbp * 1e9)
    scale = total / (sum(HG38_MBP) * 1e6)
    return [int(m * 1e6 * scale) for m in HG38_MBP]


def make_genome(gbp: float, K: int) -> tuple[list[np.ndarray], list[dict]]:
    """The JAX script's genome and planted families, drawn by the same calls
    in the same order.  Each family: its K-mer, `exact` and `variants` sites
    as (chrom, pos), and `count` (all its copies)."""
    lens = chrom_lengths(gbp)
    rng = np.random.default_rng(SEED)
    seqs = [rng.integers(0, 4, size=ln, dtype=np.uint8) for ln in lens]

    def plant(variant):
        ci = int(rng.integers(0, len(seqs)))
        p = int(rng.integers(0, len(seqs[ci]) - K))
        seqs[ci][p : p + K] = variant
        return ci, p

    families = []
    for _ in range(FAMILIES):
        w = rng.integers(0, 4, size=K, dtype=np.uint8)
        n0 = int(rng.integers(1, 5))
        n1 = int(rng.integers(0, 4))
        n2 = int(rng.integers(0, 4))
        exact = [plant(w) for _ in range(n0)]
        variants = []
        for _ in range(n1):
            v = w.copy()
            j = int(rng.integers(0, K))
            v[j] = (v[j] + 1 + rng.integers(0, 3)) % 4
            variants.append((plant(v), v))
        for _ in range(n2):
            v = w.copy()
            j1, j2 = rng.choice(K, size=2, replace=False)
            v[j1] = (v[j1] + 1 + rng.integers(0, 3)) % 4
            v[j2] = (v[j2] + 1 + rng.integers(0, 3)) % 4
            variants.append((plant(v), v))
        families.append(dict(kmer=w, exact=exact, variant_kmers=[v for _, v in variants],
                             variants=[s for s, _ in variants], count=n0 + n1 + n2))
    return seqs, families


def check_planted_intact(seqs: list[np.ndarray], families: list[dict], K: int) -> None:
    """Every planted copy must still be in place: a later copy planted over
    an earlier one would make the expected counts wrong (likely only on a
    genome of a few Mbp)."""
    for fi, fam in enumerate(families):
        sites = [(s, fam["kmer"]) for s in fam["exact"]]
        sites += list(zip(fam["variants"], fam["variant_kmers"]))
        for (ci, p), km in sites:
            if not np.array_equal(seqs[ci][p : p + K], km):
                raise CheckFailed(f"family {fi}: the copy at chr{ci + 1}:{p} was "
                                  "overwritten by a later one; its counts do not hold")


# ---- preflight -----------------------------------------------------------------

def plan_parts(lens: list[int], max_part: int) -> list[tuple[int, int, int]]:
    """(first, end, both-strand symbols) of each part, as `build_index`
    partitions (greedy over whole chromosomes)."""
    from genmap_tpu_torch.index.build import _partition

    arr = np.asarray(lens, dtype=np.uint64)
    return [(s, e, 2 * int((arr[s:e] + 1).sum())) for s, e in _partition(arr, max_part)]


def host_facts(path: str) -> dict:
    mem = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                mem = int(line.split()[1]) * 1024
    cpu = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    os.makedirs(path, exist_ok=True)
    return dict(mem_available=mem, nproc=os.cpu_count(), cpu=cpu,
                disk_free=shutil.disk_usage(path).free)


def preflight(lens: list[int], max_part: int, workers: int, out: str,
              bytes_per_symbol: float) -> dict:
    """Print the plan and what it needs; raise when RAM or disk is short."""
    host = host_facts(out)
    parts = plan_parts(lens, max_part)
    sizes = sorted((n for _, _, n in parts), reverse=True)
    w = max(1, min(workers, len(parts)))
    genome = sum(lens)
    # the w largest part builds at once, each with its bases pickled to its
    # worker, and the parent's genome
    ram = int(sum(sizes[:w]) * (bytes_per_symbol + 0.5)) + genome
    n_all = sum(sizes)
    index_bytes = int(n_all * INDEX_B_TEXT + sum(
        n * (INDEX_B_MONO + (INDEX_B_DIMER if n < 2**31 else 0)) for n in sizes))
    spill = workers > 1 and len(parts) > 1
    disk = index_bytes * (2 if spill else 1)
    log(f"[preflight] host: {host['nproc']} CPUs ({host['cpu']}), MemAvailable "
        f"{host['mem_available'] / 2**30:.1f} GiB, free disk under {out} "
        f"{host['disk_free'] / 2**30:.1f} GiB")
    for i, (s, e, n) in enumerate(parts):
        log(f"[preflight] part {i}: chr{s + 1}-chr{e} ({e - s} sequences), {n:,} "
            f"both-strand symbols, {'>=' if n >= 2**31 else '<'} 2^31 "
            f"({'no dimer rows' if n >= 2**31 else 'dimer rows'})")
    log(f"[preflight] {len(parts)} parts, {w} built at once: RAM needed ~{ram / 2**30:.1f} GiB "
        f"({bytes_per_symbol:g} B per symbol of the {w} largest parts, their bases and the "
        f"genome); disk ~{disk / 2**30:.1f} GiB (the index{' and its spilled parts' if spill else ''}); "
        f"a part >= 2^31 symbols: {any(n >= 2**31 for n in sizes)}")
    short = []
    if host["mem_available"] is not None and ram > host["mem_available"]:
        short.append(f"RAM: needs ~{ram / 2**30:.1f} GiB, {host['mem_available'] / 2**30:.1f} "
                     "available (lower --max-part-symbols or --workers)")
    if disk > host["disk_free"]:
        short.append(f"disk: needs ~{disk / 2**30:.1f} GiB, {host['disk_free'] / 2**30:.1f} free")
    if short:
        raise RuntimeError("preflight: " + "; ".join(short))
    return dict(host=host, parts=[dict(first=s, end=e, symbols=n) for s, e, n in parts],
                workers=w, ram_needed=ram, disk_needed=disk)


# ---- records -------------------------------------------------------------------

class Maps:
    """Runs each map with the launch counters at 0 and the device's peak
    memory reset just before, and keeps its record."""

    def __init__(self, device):
        self.device = device
        self.records = []

    def run(self, name: str, eng, layout, params, errors: int, intervals, csv=False):
        import torch

        from genmap_tpu_torch import kernels

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t = time.perf_counter()
        res = eng.compute_file(layout, params, errors, CAP, intervals=intervals, csv=csv)
        if cuda:
            torch.cuda.synchronize()
        sec = time.perf_counter() - t
        nk = sum(e - b for b, e in intervals)
        J = params.length - params.overlap + 1
        rec = dict(
            name=name, kmers=nk, compute_s=sec, kmers_per_s=nk / sec if sec else None,
            route=route(eng.stats, J),
            launches={n: c for n, c in kernels.launch_counts().items() if c},
            part_resident_bytes=[ix.resident_bytes() for ix in eng.resident_indices()],
            max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None,
        )
        self.records.append(rec)
        log(f"[map] {name}: {nk:,} k-mers in {sec:.3f} s ({rec['kmers_per_s']:,.0f} k-mers/s); "
            f"route {rec['route']}; launches {rec['launches']}; part resident bytes "
            f"{rec['part_resident_bytes']}; max_memory_allocated {rec['max_memory_allocated']}")
        return res


# ---- main --------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m genmap_tpu_torch.scripts.hg38_demo")
    ap.add_argument("--gbp", type=float, default=3.1)
    ap.add_argument("--out", default=os.path.expanduser("~/.cache/genmap_tpu_torch/hg38"))
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--errors", type=int, default=2)
    ap.add_argument("--skip-build", action="store_true")
    ap.add_argument("--batch-blocks", type=int, default=16384)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the maps (default cuda; cpu runs the plain versions)")
    ap.add_argument("--max-part-symbols", type=int, default=None,
                    help="cap on each part's both-strand symbols (index -xm)")
    ap.add_argument("--workers", type=int, default=2, help="parts built at once")
    ap.add_argument("--bytes-per-symbol", type=float, default=28.0,
                    help="the preflight's SA-IS peak per both-strand symbol")
    ap.add_argument("--slice", type=int, default=200_000,
                    help="k-mers of the overlap-invariance slice")
    args = ap.parse_args(argv)

    from genmap_tpu_torch.hostmem import retain_heap
    from genmap_tpu_torch.ops.rank import resolve_device

    device = resolve_device(args.device)  # raises without a card
    retain_heap()
    K, E = args.k, args.errors
    stages: dict = {}
    ok = True

    def stage(name, t0):
        stages[name] = time.perf_counter() - t0
        log(f"[stage] {name}: {stages[name]:.1f} s")

    log(f"[gpu] {gpu_line(device.type)}")
    from genmap_tpu_torch.index.build import MAX_PART_SYMBOLS

    max_part = args.max_part_symbols or MAX_PART_SYMBOLS
    lens = chrom_lengths(args.gbp)
    os.makedirs(args.out, exist_ok=True)
    idx_dir = os.path.join(args.out, "idx")
    skip = args.skip_build and os.path.exists(os.path.join(idx_dir, "meta.json"))
    plan = None if skip else preflight(lens, max_part, args.workers, args.out,
                                       args.bytes_per_symbol)
    if device.type == "cuda":
        from genmap_tpu_torch import kernels

        t = time.perf_counter()
        kernels.build()
        stage("kernels", t)

    # ---- genome -----------------------------------------------------------------
    t = time.perf_counter()
    seqs, families = make_genome(args.gbp, K)
    check_planted_intact(seqs, families, K)
    stage("gen", t)
    log(f"[gen] {sum(lens) / 1e9:.3f} Gbp random genome, {FAMILIES} planted families "
        f"({sum(f['count'] for f in families)} copies)")

    # ---- index ------------------------------------------------------------------
    from genmap_tpu_torch.index.build import build_index
    from genmap_tpu_torch.index.fmindex import FMIndexData
    from genmap_tpu_torch.io.fasta import FastaFile

    if skip:
        log(f"[index] reusing {idx_dir}")
    else:
        ff = FastaFile(name="hg38_synth.fa")
        ff.ids = [f"chr{i + 1}" for i in range(len(seqs))]
        ff.seqs = seqs
        t = time.perf_counter()
        data = build_index([ff], sampling=10, workers=args.workers, max_part_symbols=max_part,
                           spill_dir=os.path.join(args.out, "spill"))
        stage("build", t)
        log(f"[index] built {len(data.parts)} parts ({sum(lens) / 1e6 / stages['build']:.2f} "
            f"Mbp/s, {2 * sum(lens) / stages['build']:,.0f} symbols/s)")
        t = time.perf_counter()
        if os.path.exists(idx_dir):
            shutil.rmtree(idx_dir)
        data.save(idx_dir)
        del data, ff
        stage("save", t)
    t = time.perf_counter()
    data = FMIndexData.load(idx_dir, mmap=True)
    stage("load", t)
    del seqs
    part_info = [dict(n_total=p.n_total, seq_off=p.seq_off, nseq=p.nseq_part,
                      dimer=p.dimer is not None) for p in data.parts]
    for i, p in enumerate(part_info):
        log(f"[index] part {i}: {p['n_total']:,} both-strand symbols "
            f"({'>=' if p['n_total'] >= 2**31 else '<'} 2^31), seq_off {p['seq_off']}, "
            f"{p['nseq']} sequences, dimer rows {p['dimer']}")
    if len(data.parts) < 2:
        raise CheckFailed("the genome must split into >= 2 parts")

    # ---- map ------------------------------------------------------------------------
    from genmap_tpu_torch.cli.map_cmd import default_overlap
    from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams

    maps = Maps(device)
    t = time.perf_counter()
    eng = MappabilityEngine(data, batch_blocks=args.batch_blocks, light=True, device=device)
    stage("upload", t)
    log(f"[map] dimer tiers allowed: {eng._dimer_ok} (every part needs dimer rows)")
    layout = eng.layouts[0]
    c21_begin = int(layout.cum_lens[CHR21])
    c21_end = int(layout.cum_lens[CHR21 + 1])
    log(f"[map] chr21: global text positions {c21_begin + layout.start:,}-"
        f"{c21_end + layout.start:,} ({'past' if c21_begin >= 2**31 else 'below'} 2^31)")
    x = min(default_overlap(K, E), K - 1, K - E - 2)
    params = SearchParams(length=K, overlap=K - x, rev_compl=True)
    sel = [(c21_begin, c21_end - K + 1)]
    t = time.perf_counter()
    res = maps.run("chr21", eng, layout, params, E, sel)
    stage("map_chr21", t)
    c21 = res.c[c21_begin:c21_end].copy()
    del res

    # planted sites inside the selection
    def gpos(site):
        return int(layout.cum_lens[site[0]]) + site[1]

    errors = checked = 0
    for fam in families:
        for site in fam["exact"]:
            gp = gpos(site)
            if c21_begin <= gp < c21_end - K + 1:
                checked += 1
                if int(c21[gp - c21_begin]) != fam["count"]:
                    errors += 1
                    log(f"[diff] MISMATCH chr{site[0] + 1}:{site[1]} got "
                        f"{int(c21[gp - c21_begin])} expect {fam['count']}")
    log(f"[diff] planted-site spot-check: {checked} sites in the selection, "
        f"{errors} mismatches")

    # every family's first exact site, one position each
    t = time.perf_counter()
    tgt = [(gpos(f["exact"][0]), f["count"]) for f in families]
    res2 = maps.run("targeted", eng, layout, params, E, [(gp, gp + 1) for gp, _ in tgt])
    got2 = [int(res2.c[gp]) for gp, _ in tgt]
    del res2
    diff2 = sum(g != want for g, (_, want) in zip(got2, tgt))
    for (gp, want), g in zip(tgt, got2):
        if g != want:
            log(f"[diff] MISMATCH targeted global {gp} got {g} expect {want}")
    stage("targeted", t)
    log(f"[diff] all-{FAMILIES}-families targeted check: {diff2} mismatches")

    # overlap invariance on a slice
    t = time.perf_counter()
    sl = [(c21_begin, c21_begin + args.slice)]
    pa = SearchParams(length=K, overlap=params.overlap, rev_compl=True)
    pb = SearchParams(length=K, overlap=max(params.overlap - 3, E + 2), rev_compl=True)
    ca = maps.run(f"slice o={pa.overlap}", eng, layout, pa, E, sl).c[sl[0][0]:sl[0][1]].copy()
    cb = maps.run(f"slice o={pb.overlap}", eng, layout, pb, E, sl).c[sl[0][0]:sl[0][1]].copy()
    inv_ok = bool(np.array_equal(ca, cb))
    stage("overlap", t)
    log(f"[diff] overlap invariance (o={pa.overlap} vs {pb.overlap}, {args.slice:,} k-mers): "
        f"{'OK' if inv_ok else 'MISMATCH'}")

    # wig and bedgraph of the chr21 slice
    from genmap_tpu_torch.io.writers import save_bedgraph, save_wig

    t = time.perf_counter()
    save_wig(c21, os.path.join(args.out, "chr21"), ["chr21"], np.asarray([len(c21)]), True)
    stage("wig", t)
    t = time.perf_counter()
    save_bedgraph(c21, os.path.join(args.out, "chr21"), ["chr21"], np.asarray([len(c21)]),
                  True, True)
    stage("bedgraph", t)
    del eng
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()

    # ---- locate ------------------------------------------------------------------------
    t = time.perf_counter()
    eng2 = MappabilityEngine(data, batch_blocks=args.batch_blocks, light=False, device=device)
    stage("upload_full", t)
    t = time.perf_counter()
    res3 = maps.run("locate", eng2, layout, params, E, [(gp, gp + 1) for gp, _ in tgt], csv=True)
    loc_errors = 0
    located_rows = 0
    for fi, fam in enumerate(families):
        ci, p = fam["exact"][0]
        want = sorted(fam["exact"] + fam["variants"])
        freq = int(res3.c[gpos((ci, p))])
        entry = res3.locations.get((ci, p))
        if entry is None:
            fwd, rc = [], []
        else:
            (f1, f2), (r1, r2) = entry
            fwd = sorted(zip(map(int, f1), map(int, f2)))
            rc = sorted(zip(map(int, r1), map(int, r2)))
        located_rows += len(fwd) + len(rc)
        if fwd != want or rc or freq != fam["count"]:
            loc_errors += 1
            log(f"[locate] MISMATCH family {fi} at chr{ci + 1}:{p}: frequency {freq} "
                f"(expect {fam['count']}), forward {fwd} (expect {want}), reverse {rc}")
    del res3, eng2
    stage("locate", t)
    log(f"[locate] {FAMILIES} families, {located_rows} located sites: {loc_errors} mismatches")

    planted_mismatches = errors + diff2
    ok = planted_mismatches == 0 and inv_ok and loc_errors == 0
    summary = dict(
        genome_bp=sum(lens), gpu=gpu_line(device.type), preflight=plan, parts=part_info,
        chr21=dict(begin=c21_begin + layout.start, end=c21_end + layout.start,
                   sha256=hashlib.sha256(c21.tobytes()).hexdigest()),
        stages=stages, maps=maps.records,
        map_kmers_per_sec=maps.records[0]["kmers_per_s"],
        planted_checked=checked, planted_mismatches=planted_mismatches,
        overlap_invariant=inv_ok, locate_mismatches=loc_errors, located_rows=located_rows,
        wig_secs=stages["wig"], bedgraph_secs=stages["bedgraph"], ok=ok,
    )
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    log("[done] " + json.dumps(summary, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
