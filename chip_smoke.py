#!/usr/bin/env python3
"""Smoke test of genmap_tpu_torch on one NVIDIA GPU: kernels, main path,
cross-check.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card; it needs
nvcc (CUDA_HOME or PATH) and g++, and no network.  It imports nothing of JAX
or of the JAX package.  Phases (any failure exits non-zero):

  1. build   every CUDA kernel of the port from csrc/ (one nvcc per source,
             in parallel)
  2. dna5    on a ~1 Mbp genome-like Dna5 index (A = 5 candidates), one
             (100,2) batch of B=1024 blocks runs through the block mapper;
             every kernel call is also computed by its plain PyTorch version
             on the card and must agree exactly
  3. main    `genmap-tpu-torch index` of a 12.07 Mbp genome-like genome laid
             out as S. cerevisiae's 16 nuclear chromosomes (Dna4), then
             `genmap-tpu-torch map -K 100 -E 2` of the whole genome on the
             card, four times:
             - a checked run: every kernel call of the seed-table build and
               of the first batch of each tier is held against its plain
               version (exactly), and that batch is profiled
             - three timed runs: launch counters set to 0 just before and
               read just after each; every kernel must have launched; the
               k-mers/s figure is their median
  4. kernels the largest checked call of each kernel is timed on the card
             (kernel, plain version, library call where one exists) beside
             its bound
  5. check   the same map on the CPU (plain PyTorch path) for a BED selection
             of >= 20,000 k-mers spread over the genome, half of them in
             repeat-rich windows; frequencies must equal the card's exactly

Output: a line per kernel, `{"kernels": [...]}`, the card's name and power
limit (nvidia-smi), and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3 peak of one H100 SXM (NVIDIA data sheet)
# 32-bit operations outside the tensor cores: the data sheet's float32 rate;
# integer ops issue at no more than it, so ops / this rate is a lower bound
H100_OPS_PER_S = 67e12
SEED = 2026

# S. cerevisiae (sacCer3) nuclear chromosome lengths, chrI..chrXVI
YEAST_CHROMS = (
    ("chrI", 230218), ("chrII", 813184), ("chrIII", 316620), ("chrIV", 1531933),
    ("chrV", 576874), ("chrVI", 270161), ("chrVII", 1090940), ("chrVIII", 562643),
    ("chrIX", 439888), ("chrX", 745751), ("chrXI", 666816), ("chrXII", 1078177),
    ("chrXIII", 924431), ("chrXIV", 784333), ("chrXV", 1091291), ("chrXVI", 948066),
)
K, E = 100, 2
DNA5_BP = 1_000_000  # Dna5 index of phase 2
B_DNA5 = 1024  # blocks in phase 2's (100,2) batch
TIMED_RUNS = 3
NAMES = ("extract_needles", "candidate_step", "compact", "count_tail")
_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


_FLUSH = []


def device_ms(fn, reps: int = 10, cold: bool = True) -> float:
    """Median device time of one fn() call, in ms (CUDA events around it).

    Each call is queued behind device work of ~0.1 ms, so that its launches
    are enqueued before the device reaches the start event and the host's
    issue time is not counted.  cold=True: that work writes 256 MiB, which
    evicts the 50 MB L2, so fn reads its inputs from HBM; cold=False: it
    spins without touching memory, and fn finds in L2 what the previous call
    left there.  A function that synchronises inside (the plain versions) is
    timed with that host time included."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        if cold:
            _FLUSH[0].zero_()
        else:
            torch.cuda._sleep(200_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        ev.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def max_abs_err(got, want) -> int:
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


# ---------------------------------------------------------------------------
# genome-like input
# ---------------------------------------------------------------------------


def write_fasta(path: str, chroms) -> None:
    with open(path, "wb") as f:
        for name, codes in chroms:
            f.write(f">{name}\n".encode())
            s = _ACGTN[codes]
            n = len(s)
            full = n // 80 * 80
            lines = np.full((n // 80, 81), ord("\n"), dtype=np.uint8)
            lines[:, :80] = s[:full].reshape(-1, 80)
            f.write(lines.tobytes())
            if n > full:
                f.write(s[full:].tobytes() + b"\n")


def yeast_like_genome():
    from genmap_tpu_torch.corpus import make_genomelike

    total = sum(n for _, n in YEAST_CHROMS)
    codes = make_genomelike(total, seed=SEED)
    chroms, pos = [], 0
    for name, n in YEAST_CHROMS:
        chroms.append((name, codes[pos : pos + n]))
        pos += n
    return chroms


# ---------------------------------------------------------------------------
# kernel calls against their plain versions, batch profiles
# ---------------------------------------------------------------------------


def profile_batch(run, label: str) -> None:
    """Wall time of one batch beside the device time of everything it ran
    on the card, by name (torch.profiler; device time reads "not measured"
    when the trace holds none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            dev.append((us / 1e3, ev.count, ev.key))
    if not dev:
        log(f"profile: {label}: wall {wall_ms:.2f} ms; device time not measured")
        return
    dev_ms = sum(d[0] for d in dev)
    log(f"profile: {label}: wall {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
        f"({100 * dev_ms / wall_ms:.1f}% of wall, {sum(d[1] for d in dev)} device ops)")
    for ms_, n, key in sorted(dev, reverse=True)[:6]:
        log(f"profile:   {ms_:8.3f} ms {n:6d}x ({1e3 * ms_ / n:.1f} us each) {key[:80]}")


class _Checker:
    """While `on`, every call of a kernel wrapper made through the engine is
    also computed by the kernel's plain version (`kernels.<name>_plain`) on
    the same inputs and must agree exactly; the largest call of each kernel
    seen while `keep` is set is kept for timing."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.on, self.keep, self.phase = False, False, ""
        self.calls = {n: 0 for n in NAMES}
        self.err = {n: 0 for n in NAMES}
        self.variants = {n: set() for n in NAMES}
        self.largest = {n: None for n in NAMES}
        self.orig = {}

    def __enter__(self):
        for n in NAMES:
            orig = getattr(self.kernels, n)
            self.orig[n] = orig
            sig = inspect.signature(orig)

            def wrapper(*a, _n=n, _orig=orig, _sig=sig, **kw):
                got = _orig(*a, **kw)
                if self.on:
                    self._check(_n, _sig.bind(*a, **kw).arguments, got)
                return got

            setattr(self.kernels, n, wrapper)
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.kernels, n, f)

    def _check(self, name, args, got):
        want = getattr(self.kernels, f"{name}_plain")(**args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        self.calls[name] += 1
        self.err[name] = max(self.err[name], err)
        self.variants[name].add(variant(name, args))
        if err:
            raise AssertionError(f"{name} differs from its plain version in "
                                 f"{self.phase} (max abs err {err}, "
                                 f"{variant(name, args)})")
        size = sum(x.numel() for x in args.values() if hasattr(x, "numel"))
        if self.keep and (self.largest[name] is None or size > self.largest[name][0]):
            self.largest[name] = (size, args, self.phase)


def variant(name, args) -> str:
    if name == "extract_needles":
        return f"B={args['starts'].shape[0]} Ln={args['Ln']} N-mask={args['nwords'].numel() > 0}"
    if name == "candidate_step":
        return (f"A={args['index'].nchars} R={args['st'].shape[0]} "
                f"{'exact' if args['exact'] else 'fast'}")
    if name == "compact":
        return f"M={args['arrays'].shape[2]} F={args['F']}"
    N = args["valid"].numel()
    return f"Fe={N // (args['cnt'].numel() * args['J'])} rc={args['rev_compl']}"


def kernel_work(name, args):
    """(bytes, operations, shape, row reads) of one call: each input byte
    that these inputs need read once (validity flags of every slot, the
    operands of valid slots only) and each output byte written once; row
    reads are the candidate step's per-state rank-row reads."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.index.fmindex import sub_width
    from genmap_tpu_torch.ops import rank

    if name == "extract_needles":
        Bn, Ln = args["starts"].shape[0], args["Ln"]
        nbytes = (Bn * 4 + Bn * Ln + Bn * ((Ln + 15) // 16 + 1) * 4
                  + (Bn * ((Ln + 31) // 32 + 1) * 4 if args["nwords"].numel() else 0))
        nops = 10 * Bn * Ln  # index, shift, mask, N test per symbol
        return nbytes, nops, f"B={Bn} Ln={Ln}", 0
    if name == "candidate_step":
        ix, st, valid = args["index"], args["st"], args["valid"]
        R, N = st.shape
        A = ix.nchars
        G = args["right"].shape[0]
        _blk, g = kernels._state_groups(st, args["per_block"], args["inner"], G)
        active = args["act"].bool()[g]
        work = valid.bool() & active
        nwork = int(work.sum())
        n_idle = N - int(active.sum())  # pass through: every row copied
        r = args["right"].bool()[g]
        mlo = torch.where(r, rank.u32(st[1]), rank.u32(st[0]))[work]
        hi = (mlo + rank.u32(st[2])[work]) & rank.MASK32
        if args["exact"]:  # first half of the row at each bound
            addr = torch.cat([mlo >> 9, hi >> 9]) * 2
        else:  # the row at mlo; its second half when hi lies past it
            q = mlo >> 9
            addr = torch.cat([q * 2, (q * 2 + 1)[(hi >> 9) > q]])
        n_reads = int(addr.numel())
        n_rows = int(torch.unique(addr).numel())
        subw = sub_width(ix.has_n)
        nbytes = (N + (4 * N if R == 5 else 0)  # validity, plan ids
                  + 4 * (4 * nwork + (R - (R == 5)) * n_idle)  # state rows
                  + n_rows * subw * 4  # distinct rank sub-rows
                  + R * N * A * 4 + N * A + N)  # outputs
        # per bound: 32 code words x (3 popcounts + ~7 mask ops) and two
        # 16-word bitvectors x 4 ops; then ~20 ops per candidate
        nops = nwork * (2 * (32 * 10 + 2 * 16 * 4) + 20 * A)
        shape = (f"N={N} states ({nwork} valid) R={R} A={A} "
                 f"{'exact' if args['exact'] else 'fast'}, {n_reads} sub-row reads "
                 f"of {n_rows} distinct sub-rows")
        return nbytes, nops, shape, n_reads
    if name == "compact":
        R, nrows, M = args["arrays"].shape
        F = args["F"]
        kept = int(args["valid"].bool().sum(dim=-1).clamp(max=F).sum())
        nbytes = nrows * M + R * kept * 4 + R * nrows * F * 4 + nrows * F + nrows
        nops = 6 * nrows * M  # ballot, rank popcount, compare per slot
        return nbytes, nops, f"R={R} rows={nrows} M={M} F={F}", 0
    cnt, J = args["cnt"], args["J"]
    N = args["valid"].numel()
    nvalid = int(args["valid"].sum())
    nbytes = (N + 2 * nvalid * 4 + cnt.numel() * 4 + cnt.numel() * J * 2
              + (0 if args["rev_compl"] else 2 * nvalid * 20))
    nops = 6 * N + (0 if args["rev_compl"] else 30 * nvalid)
    return nbytes, nops, f"B={cnt.numel()} J={J} Fe={N // (cnt.numel() * J)} valid={nvalid}", 0


def library_fn(name, args):
    """One PyTorch call computing the same function, where there is one."""
    import torch

    if name != "compact":
        return None
    arrays, valid, F = args["arrays"], args["valid"], args["F"]
    R = arrays.shape[0]

    def library():  # stable sort on the validity key + gather
        order = torch.sort((valid == 0).to(torch.uint8), dim=-1, stable=True).indices
        idx = order[:, :F].unsqueeze(0).expand(R, -1, -1)
        return torch.gather(arrays, 2, idx)

    return library


def time_kernels(checker):
    """Phase 4: the largest checked main-path call of each kernel, timed."""
    from genmap_tpu_torch import kernels

    rows = []
    for name in NAMES:
        if checker.largest[name] is None:
            raise AssertionError(f"{name}: no main-path call was checked")
        _size, args, phase = checker.largest[name]
        wrapper = checker.orig[name]
        plain = getattr(kernels, f"{name}_plain")
        ms = device_ms(lambda: wrapper(**args))
        warm_ms = device_ms(lambda: wrapper(**args), cold=False)
        plain_ms = device_ms(lambda: plain(**args), reps=5)
        lib = library_fn(name, args)
        library_ms = device_ms(lib) if lib is not None else None
        nbytes, nops, shape, n_reads = kernel_work(name, args)
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = nops / H100_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"kernel {name}: {checker.calls[name]} checked calls equal to plain "
            f"(variants: {', '.join(sorted(checker.variants[name]))}); largest, "
            f"in {phase}: {shape}: {ms:.4f} ms with L2 flushed, {warm_ms:.4f} ms "
            f"warm (plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}: "
            f"{nbytes} B, {nops} ops"
            + (f", library {library_ms:.4f} ms" if library_ms is not None else "")
            + ")" + (f" rows_per_s={n_reads / (ms * 1e-3):.3e} flushed, "
                     f"{n_reads / (warm_ms * 1e-3):.3e} warm" if n_reads else ""))
        rows.append(dict(
            name=name, route="cuda", source=f"genmap_tpu_torch/csrc/{kernels.KERNELS[name].source}",
            replaces=kernels.KERNELS[name].replaces, launches=0,
            max_abs_err=checker.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        ))
    return rows


# ---------------------------------------------------------------------------
# phase 2: the Dna5 batch
# ---------------------------------------------------------------------------


def dna5_phase(dev, checker):
    import torch

    from genmap_tpu_torch.cli.map_cmd import default_overlap
    from genmap_tpu_torch.corpus import make_genomelike
    from genmap_tpu_torch.index.build import build_index
    from genmap_tpu_torch.io.fasta import FastaFile
    from genmap_tpu_torch.ops import rank
    from genmap_tpu_torch.search.engine import DEFAULT_TIERS, BlockMapper

    t = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    seq = make_genomelike(DNA5_BP, seed=SEED + 1)
    for s in rng.integers(0, len(seq) - 2000, 40):  # N runs (Dna5)
        seq[s : s + int(rng.integers(10, 1500))] = 4
    ff = FastaFile(name="dna5.fa")
    ff.ids, ff.seqs = ["chrK"], [seq]
    data = build_index([ff], sampling=10)
    index = rank.DeviceIndex.from_part(data, data.parts[0], light=True, device=dev)
    text = rank.DeviceText.from_host(data, dev)
    log(f"dna5: {DNA5_BP} bp Dna5 index built and uploaded in "
        f"{time.perf_counter() - t:.2f} s")

    x = min(default_overlap(K, E), min(K - 1, K - E - 2))
    o = K - x
    J = K - o + 1
    nk = data.text_len - K + 1
    starts = np.sort(rng.choice(np.arange(0, nk - J, J), B_DNA5, replace=False))
    cnt = torch.full((B_DNA5,), J, dtype=torch.int32, device=dev)
    st_t = torch.from_numpy(starts.astype(np.uint32).view(np.int32)).to(dev)
    mapper = BlockMapper(index, text, K=K, errors=E, overlap=o, J=J, B=B_DNA5,
                         tier=DEFAULT_TIERS[0], cap=65535, rev_compl=True)
    before = dict(checker.calls)
    checker.on, checker.phase = True, f"the Dna5 (100,2) B={B_DNA5} batch"
    try:
        mapper(st_t, cnt, data.text_len)
        torch.cuda.synchronize()
    finally:
        checker.on = False
    n = {k: checker.calls[k] - before[k] for k in NAMES}
    log(f"dna5: one (100,2) B={B_DNA5} batch: kernel calls equal to plain {n}")
    if min(n.values()) == 0:
        raise AssertionError(f"the Dna5 batch did not call every kernel: {n}")


# ---------------------------------------------------------------------------
# phases 3 and 5: the main path through the CLI, and the CPU cross-check
# ---------------------------------------------------------------------------


def selection(chroms, gpu_freq, want=24_000, win=500):
    """BED windows of k-mer starts: half spread evenly over the genome, half
    centred on the most repeated positions of the card's result."""
    cum = np.cumsum([0] + [len(c) for _, c in chroms])
    n_even = want // (2 * win) + 1
    starts = np.linspace(0, cum[-1] - win - K, n_even).astype(np.int64)
    order = np.argsort(-gpu_freq.astype(np.int64), kind="stable")
    rep = []
    for p in order:
        if len(rep) >= n_even:
            break
        if all(abs(int(p) - q) >= win for q in rep):
            rep.append(int(p))
    wins = []
    for g in list(starts) + [max(0, p - win // 2) for p in rep]:
        ci = int(np.searchsorted(cum, g, side="right") - 1)
        b = int(g - cum[ci])
        e = min(b + win, len(chroms[ci][1]) - K + 1)
        if e > b:
            wins.append((chroms[ci][0], b, e, ci))
    return wins, cum


def checked_map(idx, out, checker) -> None:
    """The map with every kernel call of the seed-table build and of the
    first batch of each tier held against its plain version; that batch is
    profiled first."""
    from genmap_tpu_torch.cli.map_cmd import map_main
    from genmap_tpu_torch.engine.mappability import MappabilityEngine

    orig = MappabilityEngine._run_batch
    seen = set()

    def run_batch(self, run, layout, bstarts, bcnts, B):
        if id(run) in seen:
            checker.on = False
            return orig(self, run, layout, bstarts, bcnts, B)
        seen.add(id(run))
        t = run.tier
        label = (f"first batch of tier(f_search={t.f_search}, f_extend={t.f_extend}, "
                 f"exact={t.exact}) B={B} ({len(bstarts)} blocks)")
        checker.on = False
        profile_batch(lambda: orig(self, run, layout, bstarts, bcnts, B), label)
        checker.on, checker.keep, checker.phase = True, True, label
        try:
            return orig(self, run, layout, bstarts, bcnts, B)
        finally:
            checker.on = checker.keep = False

    MappabilityEngine._run_batch = run_batch
    checker.on, checker.phase = True, "the seed-table build"
    before = dict(checker.calls)
    t = time.perf_counter()
    try:
        rc = map_main(["-I", idx, "-O", out + "/", "-K", str(K), "-E", str(E),
                       "-fl", "-r", "--device", "cuda"])
    finally:
        MappabilityEngine._run_batch = orig
        checker.on = checker.keep = False
    if rc != 0:
        raise AssertionError(f"checked map exited {rc}")
    n = {k: checker.calls[k] - before[k] for k in NAMES}
    log(f"main: checked map ({len(seen)} tier programs) in "
        f"{time.perf_counter() - t:.2f} s: kernel calls equal to plain {n}")


def main_path(dev, work, checker):
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.cli.main import main as cli_main
    from genmap_tpu_torch.cli.map_cmd import map_main

    t = time.perf_counter()
    chroms = yeast_like_genome()
    n_bp = sum(len(c) for _, c in chroms)
    fa = os.path.join(work, "yeastlike.fa")
    write_fasta(fa, chroms)
    log(f"main: {n_bp} bp genome-like genome ({len(chroms)} chromosomes) written "
        f"in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    idx = os.path.join(work, "idx")
    if cli_main(["index", "-F", fa, "-I", idx]) != 0:
        raise AssertionError("genmap-tpu-torch index failed")
    log(f"main: index built in {time.perf_counter() - t:.2f} s")

    def freq_of(out):
        f = np.fromfile(os.path.join(out, "yeastlike.genmap.freq16"), dtype="<u2")
        if f.shape[0] != n_bp:
            raise AssertionError("frequency vector has the wrong length")
        return f

    cout = os.path.join(work, "checked")
    os.makedirs(cout)
    checked_map(idx, cout, checker)
    checked_freq = freq_of(cout)

    runs, launches = [], None
    log(f"main: host load average before the timed runs {os.getloadavg()}, "
        f"{os.cpu_count()} cores")
    for i in range(TIMED_RUNS):
        gout = os.path.join(work, f"gpu{i}")
        os.makedirs(gout)
        torch.cuda.reset_peak_memory_stats()
        report = {}
        kernels.reset_launches()
        t = time.perf_counter()
        rc = map_main(["-I", idx, "-O", gout + "/", "-K", str(K), "-E", str(E),
                       "-fl", "-r", "--device", "cuda"], report=report)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = kernels.launch_counts()
        if rc != 0:
            raise AssertionError(f"genmap-tpu-torch map exited {rc}")
        missing = [n for n, c in counts.items() if c <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: {missing}")
        if launches is not None and counts != launches:
            raise AssertionError(f"launch counts differ between runs: {counts} != {launches}")
        launches = counts
        gpu_freq = freq_of(gout)
        if not np.array_equal(gpu_freq, checked_freq):
            raise AssertionError("timed run's frequencies differ from the checked run's")
        st = report["stats"]
        kps = report["n_kmers"] / report["compute_s"]
        runs.append(kps)
        log(f"main: timed run {i + 1}: map -K {K} -E {E} of {report['n_kmers']} k-mers: "
            f"{report['compute_s']:.2f} s compute ({wall:.2f} s with index upload "
            f"and seed tables), {kps:.1f} k-mers/s; dispatch {st['dispatch_s']:.2f} s "
            f"fetch {st['fetch_s']:.2f} s scatter {st['scatter_s']:.2f} s; "
            f"peak allocated {torch.cuda.max_memory_allocated()} B")
    log(f"main: host load average after the timed runs {os.getloadavg()}")
    log(f"main: device bytes resident (index + text + seed tables) "
        f"{report['resident_bytes']}; tier blocks {st['tier_blocks']}, batches "
        f"{st['batches']}, escalated blocks {st['overflow_blocks']}")
    log(f"main: kernel launches per run {launches}")
    if not (gpu_freq[: len(chroms[0][1]) - K + 1] >= 1).all():
        raise AssertionError("a k-mer without N has frequency 0 (its own occurrence)")

    # phase 5: CPU cross-check on a BED selection
    wins, cum = selection(chroms, gpu_freq)
    bed = os.path.join(work, "sel.bed")
    with open(bed, "w") as f:
        for name, b, e, _ci in wins:
            f.write(f"{name}\t{b}\t{e}\n")
    mask = np.zeros(len(gpu_freq), bool)
    for _name, b, e, ci in wins:
        mask[cum[ci] + b : cum[ci] + e] = True
    pout = os.path.join(work, "cpu")
    os.makedirs(pout)
    t = time.perf_counter()
    creport = {}
    rc = map_main(["-I", idx, "-O", pout + "/", "-K", str(K), "-E", str(E),
                   "-fl", "-r", "-S", bed, "--device", "cpu"], report=creport)
    if rc != 0:
        raise AssertionError(f"CPU map exited {rc}")
    cpu_freq = freq_of(pout)
    nsel = int(mask.sum())
    bad = int((cpu_freq[mask] != gpu_freq[mask]).sum())
    log(f"check: {nsel} k-mers in {len(wins)} windows ({(gpu_freq[mask] > 1).sum()} "
        f"with frequency > 1, max {gpu_freq[mask].max()}) recomputed on the CPU in "
        f"{time.perf_counter() - t:.1f} s (tier blocks {creport['stats']['tier_blocks']}): "
        f"{bad} mismatches")
    if nsel < 20_000 or bad:
        raise AssertionError(f"cross-check failed: {nsel} k-mers, {bad} mismatches")
    return launches, dict(kmers_per_s_median=float(np.median(runs)),
                          kmers_per_s_runs=runs, n_kmers=report["n_kmers"],
                          resident_bytes=report["resident_bytes"],
                          tier_blocks=st["tier_blocks"])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("ERROR: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ERROR: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from genmap_tpu_torch import kernels
    except ImportError as e:
        print(f"ERROR: genmap_tpu_torch is not importable ({e}); run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t = time.perf_counter()
    reports = kernels.build()
    log(f"build: {len(reports)} kernels compiled in {time.perf_counter() - t:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    with _Checker(kernels) as checker:
        dna5_phase(dev, checker)
        with tempfile.TemporaryDirectory(prefix="genmap_smoke_") as work:
            launches, summary = main_path(dev, work, checker)
            rows = time_kernels(checker)
    for r in rows:
        r["launches"] = launches[r["name"]]
    log(f"main summary: {json.dumps(summary)}")
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          "nvidia-smi: no output", flush=True)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
