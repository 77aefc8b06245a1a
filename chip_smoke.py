#!/usr/bin/env python3
"""Smoke test of genmap_tpu_torch on one NVIDIA GPU: kernels, main path,
dimer tiers, dedup, CSV locations and exclude-pseudo, multi-part indexes,
meshes, the row-gather sweep, cross-checks.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card; it needs
nvcc (CUDA_HOME or PATH) and g++, and no network.  It imports nothing of JAX
or of the JAX package.  Phases (any failure exits non-zero):

  1. build   every CUDA kernel of the port from csrc/ (one nvcc per source,
             in parallel)
  2. dna5    on a ~1 Mbp genome-like Dna5 index (A = 5 candidates), one
             (100,2) batch of B=1024 blocks runs through the block mapper,
             at the mono tier 0 and at two forced dimer tiers (fast and
             exact: the index's flagged fraction is above the automatic
             gate, so only a forced tier reaches the A = 5 dimer variants
             and the N-flagged `far` path); every kernel call is also
             computed by its plain PyTorch version on the card and must
             agree exactly
  3. main    `genmap-tpu-torch index` of a 12.07 Mbp genome-like genome laid
             out as S. cerevisiae's 16 nuclear chromosomes (Dna4), then
             `genmap-tpu-torch map -K 100 -E 2` of the whole genome on the
             card (the unique-infix probe on, dimer twins before the wide
             exact tiers, occupancy calibration of each tier's cohort and,
             as J = 50 >= 16, the split pipeline, as by default), four times:
             - a checked run: every kernel call of the seed-table build
               (also checked on the Dna5 index and on each multipart part at
               the shared depth) and of the first batch of each program (the
               probe, each tier's
               calibration batch, the first phase-A batch of each tier and
               the first phase-B batch of each (rung, mode)) is held against
               its plain version (exactly), and that batch is profiled; the
               calibrated pools, extension schedules and phase-B batches and
               blocks per (tier, rung, mode) are logged
             - three timed runs: launch counters set to 0 just before and
               read just after each; every kernel of the path must have
               launched; the k-mers/s figure is their median
             then `map -K 24 -E 1` of the whole genome, whose tier 0 runs on
             the dimer rows (fused, J = 6): checked, then counted
             (dimer_step must launch); last, one more map at (24,1) and one
             at (100,2) under torch.profiler (device activity only; not
             timed runs): each kernel's launches, device ms per map, and
             median and p90 device ms per call
  4. check   `map -d` on the CPU (plain PyTorch path) and on the card for a
             BED selection of >= 20,000 k-mers spread over the genome, half
             of them in repeat-rich windows (below the probe's gate, so the
             CPU recomputes them without it): the CPU's frequencies must
             equal the main path's, and both runs' output files (frequencies
             and CSV) must be byte-equal; every kernel call of the card's
             run is held against its plain version.  Then the same selection
             without -d (the split pipeline) on the CPU and the card: files
             byte-equal, frequencies equal to the main path's
  5. csv     `map -d` of all of chrI on the card (counters reset before and
             read after; locate must launch): its frequencies must equal
             the main path's on chrI; located rows/s is logged
  6. dedup   chrI-chrIV followed by a second copy of them in one file
             (~5.8 Mbp, duplicate rate 0.5, given to the engine's dedup gate,
             whose sampled estimate cannot see two-copy duplication at this
             size), mapped at (100,2) and (24,1) through MappabilityEngine
             with dedup on and off: frequencies equal, the dedup pass taken
             in both configurations, and the first batch of each program
             held against the plain versions (including the zero-error
             outputs of count_tail)
  7. ep      a directory of two FASTA files (chrI-chrIII, and the same with
             1 % substitutions under other names): `index -FD`, then
             `map -ep -d -fl -r` over chrI of both files on the card, and over a
             >= 10,000-k-mer sub-selection on the card and on the CPU, whose
             output files must be byte-equal
  8. multipart  chrI-chrVII indexed whole and with `-xm` into three parts:
             each part's seed tables built at the depth a part mesh shares
             (the smallest part's) and checked against the plain build;
             `map -K 100 -E 2` and `-K 24 -E 1` of both on the card (first
             batch of each program checked, the probe's per-part mass sums
             included), frequencies equal; `map -d` of a >= 10,000-k-mer
             selection on the split index on the card and on the CPU, and on
             the whole index on the card: all output files byte-equal
  9. mesh1   a NCCL world of one rank (this process, cuda:0): the main
             genome mapped through `map_main(mesh=...)` on data_mesh(1) and
             on part_data_mesh(1, 1) at (100,2) and (24,1) (the fused
             ladder: the split gate is off under a mesh), each counted
             twice (k-mers/s, collectives, their bytes and host time), the
             (100,2) maps profiled (NCCL device time), the part mesh's
             (100,2) first batches checked (its part mapper, prober and
             reduced probe_mass); frequencies equal to the single-GPU
             maps'
 10. mesh4   four ranks spawned on cuda:0 over gloo: dryrun_multichip(4);
             chrI-chrVII in two parts (-xm) on part(2) x data(2) at
             (100,2) and (24,1) and the multipart phase's -d selection,
             and data(4) on its 3-part index: output files byte-equal to
             the single-GPU runs'; rank 0's first batch of every program
             held against the plain versions (the reduced probe_mass entry
             included); part(2) x data(1) over NCCL where the machine has
             two cards
 11. rowgather  `experiments/row_gather.py`, the port of the Pallas
             row-DMA harness (benchmarks/pallas_experiments.py), on the card:
             its two lines at the harness's sizes (every lanes variant equal
             to the plain version) and its sweep of random-row read rates
             over row width, table size (L2- to hg38-sized), id order,
             dependence, lanes and blocks per SM, counters set to 0 just
             before and read just after (row_gather must launch), the bulk
             copies (lanes 0) swept at the rank rows' widths (208, 276, 416,
             512 B) from the 20 MB, 256 MiB and 4 GiB tables; the kernel's edge cases
             (every lanes value, 0 included) against its plain version; the
             read rates of candidate_step and dimer_step beside the sweep's
 12. kernels the largest checked call of each kernel (and of each
             candidate_step and dimer_step variant, of compact's short-row,
             long-row and counting calls, of count_tail at Fe = 1 and with
             the zero-error outputs) is timed on the card (kernel, plain
             version, library call where one exists) beside its bound and
             the launch floor (one empty kernel timed the same way), and
             locate beside a chain yardstick (the rowgather phase's
             dependent row reads at its sub-row width, as many as its LF
             steps); compact must have been checked in each regime with
             count on and off
 13. seed tables  the build (`with_seed_tables`: seed_build's launches and
             no other kernel) on the main index: device ms, launches, bound,
             its multiple of the launch floor and its peak allocated bytes;
             then the per-batch lookup (seed_lookup) at two batch sizes

candidate_step's and dimer_step's calls are held against the plain version
under the kernel's output contract (`kernels.candidate_step_view`,
`kernels.dimer_step_view`: valid2 and far in full, out on the slots the
contract defines, and the compaction of out by valid2); every other
kernel's outputs in full.

Output: `{"kernels": [...]}` (eleven kernels), the card's name and power
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
NAMES = ("extract_needles", "candidate_step", "compact", "count_tail",
         "probe_mass", "locate", "dimer_step", "seed_lookup", "gather_states",
         "seed_build")
# the kernels of the whole-genome map (no CSV; seed_build at the index upload)
MAIN_NAMES = ("extract_needles", "candidate_step", "compact", "count_tail",
              "probe_mass", "dimer_step", "seed_lookup", "gather_states",
              "seed_build")
EP_BP = 230218 + 813184 + 316620  # chrI-chrIII
DEDUP_CHROMS = 4  # chrI-chrIV
MP_CHROMS = 7  # chrI-chrVII, the multi-part phase's genome
MP_XM = 4_000_000  # its -xm cap in symbols (both strands): three parts
MP_SEL = 10_000  # k-mers of its -d selection
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
    seen while `keep` is set is kept for timing (a checked seed_build call,
    an upload's and not a batch's, is always kept)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.on, self.keep, self.phase = False, False, ""
        self.calls = {n: 0 for n in NAMES}
        self.err = {n: 0 for n in NAMES}
        self.variants = {n: set() for n in NAMES}
        self.largest = {}  # timing_key -> (size, args, phase)
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
        if name in ("candidate_step", "dimer_step"):  # what their contracts define
            view = getattr(self.kernels, f"{name}_view")
            got, want = view(got, **args), view(want, **args)
        err = max_abs_err(got, want)
        self.calls[name] += 1
        self.err[name] = max(self.err[name], err)
        self.variants[name].add(variant(name, args))
        if err:
            raise AssertionError(f"{name} differs from its plain version in "
                                 f"{self.phase} (max abs err {err}, "
                                 f"{variant(name, args)})")
        size = sum(x.numel() for x in args.values() if hasattr(x, "numel"))
        keep = self.keep
        if name == "seed_build":
            size, keep = got[0].numel(), True
        for key in timing_keys(name, args):
            if keep and (key not in self.largest or size > self.largest[key][0]):
                self.largest[key] = (size, args, self.phase)


def timing_keys(name, args) -> list:
    """The kernel's entry (its largest call is its row in the kernels line),
    and entries logged beside it: compact's counting calls and its short-
    and long-row regimes, count_tail's zero-error outputs and its calls at
    Fe = 1, and each dimer_step variant."""
    if name == "count_tail" and args.get("with_exact"):
        return ["count_tail+exact"]
    if name == "probe_mass" and args["st"] is None:
        return ["probe_mass+reduced"]
    if name == "compact":
        regime = compact_regime(args["valid"].shape[1])
        return ([name] + (["compact+count"] if args.get("count") else [])
                + ([f"compact+{regime}"] if regime != "middle" else []))
    if name == "count_tail" and args["valid"].numel() == args["cnt"].numel() * args["J"]:
        return [name, "count_tail+fe1"]
    if name == "candidate_step":  # A, R, rank mode, passthrough groups
        return [name, f"{name}+A={args['index'].nchars},R={args['st'].shape[0]},"
                      f"{'exact' if args['exact'] else 'fast'},"
                      f"pass={not bool(args['act'].all())}"]
    if name == "dimer_step":  # A, rank mode, mono steps, passthrough slots
        return [name, f"{name}+A={args['index'].nchars},"
                      f"{'exact' if args['exact'] else 'fast'},"
                      f"mono={args['with_mono']},pass={args['with_pass']}"]
    return [name]


def compact_regime(M: int) -> str:
    """The regime `kernels.compact` takes for rows of M slots."""
    from genmap_tpu_torch import kernels

    if M <= kernels.COMPACT_SHORT_M:
        return "short"
    return "long" if kernels.compact_chunks(M) else "middle"


def variant(name, args) -> str:
    if name == "extract_needles":
        return f"B={args['starts'].shape[0]} Ln={args['Ln']} N-mask={args['nwords'].numel() > 0}"
    if name == "candidate_step":
        return (f"A={args['index'].nchars} R={args['st'].shape[0]} "
                f"{'exact' if args['exact'] else 'fast'}")
    if name == "compact":
        M = args["valid"].shape[1]
        return f"M={M} F={args['F']} count={bool(args.get('count'))} {compact_regime(M)}"
    if name == "seed_lookup":
        return (f"P={args['a_pos'].numel()} t_seed={args['t_seed']} Fp={args['Fp']} "
                f"A={args['index'].nchars}")
    if name == "gather_states":
        return f"B={args['st'].shape[1]} Fc={args['st'].shape[2]} Fe={args['Fe']}"
    if name == "probe_mass" and args["st"] is None:
        return (f"reduced P={args['thr'].numel()} "
                f"mass={bool(args.get('with_mass'))}")
    if name == "probe_mass":
        return (f"F={args['st'].shape[2]} P={args['thr'].numel()} "
                f"N-window={args['has_n']} mass={bool(args.get('with_mass'))} "
                f"acc={args.get('acc') is not None} last={args.get('last', True)}")
    if name == "dimer_step":
        return (f"A={args['index'].nchars} R={args['st'].shape[0]} "
                f"{'exact' if args['exact'] else 'fast'} mono={args['with_mono']} "
                f"pass={args['with_pass']}")
    if name == "locate":
        return f"A={args['index'].nchars} sampling={args['index'].sampling}"
    if name == "seed_build":
        return f"A={args['index'].nchars} t0={args['t0']}"
    N = args["valid"].numel()
    return (f"Fe={N // (args['cnt'].numel() * args['J'])} rc={args['rev_compl']} "
            f"exact={bool(args.get('with_exact'))}")


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
        # what the data needs: every state's validity, valid2 and far; the
        # row (and plan id) of each working (valid, active) state, its
        # distinct rank sub-rows and its R x A outputs; a valid passthrough
        # state's R values read and written once (candidate 0)
        ix, st, valid = args["index"], args["st"], args["valid"]
        R, N = st.shape
        A = ix.nchars
        G = args["right"].shape[0]
        _blk, g = kernels._state_groups(st, args["per_block"], args["inner"], G)
        active = args["act"].bool()[g]
        work = valid.bool() & active
        nwork = int(work.sum())
        npass = int((valid.bool() & ~active).sum())
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
        nbytes = (N  # validity
                  + 4 * (4 + (R == 5)) * nwork + 2 * 4 * R * npass  # state rows
                  + n_rows * subw * 4  # distinct rank sub-rows
                  + R * A * 4 * nwork + N * A + N)  # outputs
        # per bound: 32 code words x (3 popcounts + ~7 mask ops) and two
        # 16-word bitvectors x 4 ops; then ~20 ops per candidate
        nops = nwork * (2 * (32 * 10 + 2 * 16 * 4) + 20 * A)
        shape = (f"N={N} states ({nwork} working, {npass} passing through, "
                 f"{int(valid.sum())} valid) R={R} A={A} per_block={args['per_block']} "
                 f"inner={args['inner']} G={G} {'exact' if args['exact'] else 'fast'}, "
                 f"{n_reads} sub-row reads of {n_rows} distinct sub-rows")
        return nbytes, nops, shape, n_reads
    if name == "compact":
        # without count a row needs its validity only up to its (F+1)-th
        # valid slot (the kernel stops reading there)
        R, nrows, M = args["arrays"].shape
        F = args["F"]
        v = args["valid"].bool()
        nvalid = v.sum(dim=-1)
        kept = int(nvalid.clamp(max=F).sum())
        if args.get("count") or nrows * M == 0:
            n_read = nrows * M
        else:
            over = (torch.cumsum(v, dim=-1, dtype=torch.int32) > F).to(torch.uint8)
            n_read = int(torch.where(nvalid > F, over.argmax(dim=-1) + 1, M).sum())
        nbytes = (n_read + R * kept * 4 + R * nrows * F * 4 + nrows * F + nrows
                  + (4 * nrows if args.get("count") else 0))
        nops = 6 * n_read  # byte compare, popcount, scan share per slot
        return nbytes, nops, (f"R={R} rows={nrows} M={M} F={F}"
                              f"{' count' if args.get('count') else ''}, "
                              f"{compact_regime(M)} rows, {n_read} validity "
                              f"bytes needed"), 0
    if name == "seed_lookup":
        # per (block, plan): t_seed needle bytes, three 4-byte table reads;
        # the [5, B, Fp] states and [B, Fp] validity written
        Bn = args["needles"].shape[0]
        P, t, Fp = args["a_pos"].numel(), args["t_seed"], args["Fp"]
        nbytes = Bn * P * (t + (12 if t else 0)) + 4 * P + Bn * Fp * (5 * 4 + 1)
        nops = Bn * P * (8 * t + 10) + 8 * Bn * Fp
        return nbytes, nops, f"B={Bn} P={P} t_seed={t} Fp={Fp}", 0
    if name == "gather_states":
        # min(Fc, Fe) slots of four operands and validity read per row, Fe
        # written; the row ids read once
        _R, Bc, Fc = args["st"].shape
        npad, Fe = args["ridx"].numel(), args["Fe"]
        nbytes = npad * 4 + npad * min(Fc, Fe) * 17 + npad * Fe * 17
        nops = 4 * npad * Fe
        return nbytes, nops, f"npad={npad} (n={args['n']}) B={Bc} Fc={Fc} Fe={Fe}", 0
    if name == "probe_mass" and args["st"] is None:
        # the summed accumulator read, the skip bytes (and masses) written
        Bp, P = args["acc"].shape[0], args["thr"].numel()
        nbytes = 8 * Bp * (P + 1) + 4 * P + Bp + (4 * P * Bp if args.get("with_mass") else 0)
        return nbytes, 3 * Bp * (P + 1), f"B={Bp} P={P} (reduced)", 0
    if name == "probe_mass":
        st, valid = args["st"], args["valid"]
        _R, Bp, F = st.shape
        P = args["thr"].numel()
        nvalid = int(valid.sum())
        Ln = args["needles"].shape[1]
        acc_bytes = 8 * Bp * (P + 1)  # running per-part sum, in and out
        nbytes = (Bp * F + 8 * nvalid + Bp + (Bp * Ln if args["has_n"] else 0)
                  + 4 * P + (0 if args.get("last", True) else acc_bytes - Bp) + Bp
                  + (acc_bytes if args.get("acc") is not None else 0)
                  + ((4 * P + 1) * Bp if args.get("with_mass") else 0))
        nops = 4 * Bp * F + 2 * P * nvalid
        return nbytes, nops, f"B={Bp} F={F} P={P} valid={nvalid}", 0
    if name == "locate":
        return locate_work(args)
    if name == "dimer_step":
        return dimer_work(args)
    if name == "seed_build":
        return seed_build_work(args)
    cnt, J = args["cnt"], args["J"]
    N = args["valid"].numel()
    v = args["valid"].bool()
    nvalid = int(v.sum())
    exact = bool(args.get("with_exact"))
    n_exact = int((v & (args["st"][3] == 0)).sum()) if exact else 0
    n_strand = (0 if args["rev_compl"] else nvalid) + (n_exact if args["rev_compl"] else 0)
    nbytes = (N + 2 * nvalid * 4 + cnt.numel() * 4 + cnt.numel() * J * 2
              + 2 * n_strand * 20 + (nvalid * 4 + 3 * cnt.numel() * J * 4 if exact else 0))
    nops = 6 * N + 30 * n_strand + 4 * n_exact
    return nbytes, nops, (f"B={cnt.numel()} J={J} Fe={N // (cnt.numel() * J)} valid={nvalid}"
                          + (f" exact={n_exact}" if exact else "")), 0


def seed_build_parent_ops(ix, lo, sz):
    """Operations to count the four children of each parent (lo, sz) as
    csrc/seed_build.cu's sb_children does: lo's occ over the nearer half of
    its sub-row (`sb_occ`: the code words from the sub-row's start through
    lo's word, or from lo's word to the end where lo lies in the upper half
    of a sub-row that is not the last; ~10 ops a word, 12 for the start
    counts, 4 a word for the sentinel and N bit words on the same side, only
    where the sub-row's start count differs from the next one's, and always
    in the last sub-row); hi the same way, or, where hi shares lo's sub-row,
    only the words between the two offsets (`sb_occ_add`; nothing for an
    empty interval).  int64 tensor, one entry per parent."""
    import torch

    from genmap_tpu_torch.index.fmindex import sub_width
    from genmap_tpu_torch.ops import rank

    subw = sub_width(ix.has_n)
    last_sub = ix.fwd_blocks.shape[0] - 1

    def occ_ops(p):
        q, off = p >> 9, p & 511
        kb = off >> 4
        last = q == last_sub
        up = (off >= 256) & ~last
        code_words = torch.where(up, 32 - kb, kb + 1)
        bit_words = torch.where(up, 16 - (off >> 5), (off + 31) >> 5)
        rows = ix.fwd_blocks

        def differs(col):  # the sub-row's start count against the next one's
            return last | (rows[q, col] != rows[q, subw + col])

        nbit = differs(35).to(torch.int64)
        if ix.has_n:
            nbit = nbit + differs(52).to(torch.int64)
        return 10 * code_words + 12 + 4 * nbit * bit_words

    hi = (lo + sz) & rank.MASK32
    same = ((hi >> 9) == (lo >> 9)) & (hi >= lo)
    off_lo, off_hi = lo & 511, hi & 511
    between = torch.where(
        sz != 0,
        10 * (((off_hi + 15) >> 4) - (off_lo >> 4))
        + 4 * (1 + ix.has_n) * (((off_hi + 31) >> 5) - (off_lo >> 5)) + 8, 0)
    return occ_ops(lo) + torch.where(same, between, occ_ops(hi))


def seed_build_work(args, tables=None):
    """Bytes and operations of one seed_build call, as the data need them:
    the tables written once (the plain version's outputs, or `tables`) and
    each distinct rank sub-row that a bound of a parent (levels 0..t0-1)
    falls in read once; per parent the operations of its two counts
    (`seed_build_parent_ops`), and 8 per child written."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.index.fmindex import sub_width
    from genmap_tpu_torch.ops import rank

    ix, t0 = args["index"], args["t0"]
    mlo, size = tables if tables is not None else kernels.seed_build_plain(ix, t0)
    npar = rank.seed_level_offset(t0)
    lo = rank.u32(mlo[:npar])
    sz = rank.u32(size[:npar])
    hi = (lo + sz) & rank.MASK32
    bounds = torch.cat([lo, hi])
    n_rows = int(torch.unique(bounds >> 9).numel()) if npar else 0
    subw = sub_width(ix.has_n)
    nbytes = 4 * (mlo.numel() + size.numel()) + n_rows * subw * 4
    nops = int(seed_build_parent_ops(ix, lo, sz).sum()) + 8 * (mlo.numel() - 1)
    shape = (f"t0={t0} on the {ix.n_total}-symbol A={ix.nchars} index: "
             f"{mlo.numel()} entries, {npar} parents, {n_rows} distinct sub-rows read")
    return nbytes, nops, shape, 0


def dimer_work(args):
    """Bytes and operations of one dimer_step call: validity of every
    state, the rows (and plan ids) of the consuming valid states, per
    distinct dimer sub-row read the words a bound needs (2 field words, 4
    delta words, 16 threshold counts, 4 mono counts), the outputs that a
    consumer reads (valid2 and far of every state, the candidates of the
    consuming valid states, candidate 0 of a valid passthrough); per
    bound ~420 ops (16 nibble-equality masks and popcounts over 2 words,
    16 sums) and ~20 per candidate."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.ops import rank

    ix, st, valid = args["index"], args["st"], args["valid"]
    R, N = st.shape
    G = args["right"].shape[0]
    _blk, g = kernels._state_groups(st, args["per_block"], args["inner"], G)
    cons = args["consume"].to(torch.int64)[g]
    passing = (cons == 0) if args["with_pass"] else torch.zeros_like(cons, dtype=torch.bool)
    work = valid.bool() & ~passing
    nwork = int(work.sum())
    r = args["right"].bool()[g]
    mlo = torch.where(r, rank.u32(st[1]), rank.u32(st[0]))[work]
    hi = (mlo + rank.u32(st[2])[work]) & rank.MASK32
    if args["exact"]:
        subs = torch.cat([mlo >> 7, hi >> 7])
    else:  # the paired row at mlo; its second half when hi lies past it
        q = mlo >> 7
        subs = torch.cat([q, (q + 1)[(hi >> 7) > q]])
    n_reads = int(subs.numel())
    n_subs = int(torch.unique(subs).numel())
    # outputs of the working states only (16 slots of a dimer step, A of a
    # mono step), candidate 0 of a valid passthrough state; plan ids and
    # rows of those states only
    mono = (cons == 1) if args["with_mono"] else torch.zeros_like(passing)
    slots = int(torch.where(mono[work], ix.nchars, 16).sum())
    npass = int((valid.bool() & passing).sum())
    nbytes = (N + 4 * (4 + (R == 5)) * nwork + 2 * 4 * R * npass
              + n_subs * 26 * 4 + R * 4 * slots + N * 16 + N)
    nops = nwork * (2 * 420 + 16 * 20)
    mode = "exact" if args["exact"] else "fast"
    return (nbytes, nops, f"N={N} states ({nwork} valid, consuming) R={R} "
            f"A={ix.nchars} {mode} mono={args['with_mono']} pass={args['with_pass']}, "
            f"{n_reads} dimer sub-row reads of {n_subs} distinct sub-rows", n_reads)


def locate_walk(index, pos, valid):
    """The LF walks of `locate` on these rows, as its plain version takes
    them: per row its steps (a tensor), and per LF step the sub-row read,
    the offset in it and the code counted (int64 tensors), and the
    indicator words tested (one per iteration of a live row), as
    (indicator row, word) ids."""
    import torch

    from genmap_tpu_torch.index.fmindex import sub_width
    from genmap_tpu_torch.ops import rank

    subw = sub_width(index.has_n)
    C = rank.u32(index.C)
    p = rank.u32(pos)
    live = valid.bool().clone()
    steps = torch.zeros(p.shape, dtype=torch.int64, device=p.device)
    subs, offs, codes, tests = [], [], [], []
    for _ in range(index.sampling):
        if not live.any():
            break
        at = torch.nonzero(live).squeeze(1)
        q = p[at]
        off = q & 127
        tests.append((q >> 7) * 4 + (off >> 5))
        irows = rank.u32(index.ind_blocks[q >> 7])
        ibit = (irows[:, 1:].gather(1, (off >> 5)[:, None])[:, 0] >> (off & 31)) & 1
        go = ibit == 0
        q, idx = q[go], at[go]
        sub = index.fwd_blocks[q >> 9, :subw]
        code, _s = rank.bwt_char(sub, q, index.has_n)
        occ, _sent = rank._occ_sub(sub, q, index.has_n)
        subs.append(q >> 9)
        offs.append(q & 511)
        codes.append(code)
        p[idx] = (C[code] + occ.gather(1, code[:, None])[:, 0]) & rank.MASK32
        steps[idx] += 1
        live[at[~go]] = False
    empty = torch.zeros(0, dtype=torch.int64, device=p.device)
    cat = (lambda xs: torch.cat(xs) if xs else empty)  # noqa: E731
    return dict(steps=steps, sub=cat(subs), off=cat(offs), code=cat(codes),
                tests=cat(tests))


def locate_work(args):
    """Bytes and operations of one locate call, as the data need them.

    Per LF step: the code words between the offset and the nearer end of
    its sub-row (the layout holds the start counts of the sub-row and of
    the next one, so at most 16 of the 32), counted for the one code the
    step takes (a compare, a mask and a popcount: 4 ops a word); the two
    start-count groups (8 words, ~10 ops with the address and C[code] +
    occ); where the sub-row holds sentinels (code 0) or N (codes 0 and 4),
    their bit words on the same side (2 ops each); per indicator test one
    word (2 ops); per valid row its final rank (5 words, 10 ops).  Bytes:
    each distinct sub-row's words that its steps read (the most any one
    step reads), each distinct indicator word tested, per row its position,
    validity and answer, per valid row its indicator row and sample.  Also
    returns the first design's count (every code word, all four codes: 32 x
    10 + 2 x 16 x 4 + 10 ops a step), logged beside the bound."""
    import torch

    from genmap_tpu_torch.index.fmindex import sub_width
    from genmap_tpu_torch.ops import rank

    ix, pos, valid = args["index"], args["pos"], args["valid"]
    walk = locate_walk(ix, pos, valid)
    steps = int(walk["steps"].sum())
    off, sub, code = walk["off"], walk["sub"], walk["code"]
    subw = sub_width(ix.has_n)
    cw = off >> 4
    code_words = torch.minimum(cw + 1, 32 - cw)
    bit_words = torch.where(off >= 256, 16 - (off >> 5), (off + 31) >> 5)
    rows = rank.u32(ix.fwd_blocks[sub])
    last = sub == int(ix.n_total) >> 9
    has_s = last | (rows[:, 35] != rows[:, subw + 35])
    nbit = (has_s & (code == 0)).to(torch.int64)
    if ix.has_n:
        has_n = last | (rows[:, 52] != rows[:, subw + 52])
        nbit = nbit + (has_n & ((code == 0) | (code == 4))).to(torch.int64)
    step_words = code_words + 8 + nbit * bit_words + (3 if ix.has_n else 0)
    n = pos.numel()
    nvalid = int(valid.bool().sum())
    tests = int(walk["tests"].numel())
    nops = (int((4 * code_words + 2 * nbit * bit_words).sum()) + 10 * steps
            + 2 * tests + 10 * nvalid)
    sub_words = 0
    if steps:
        ids, inv = torch.unique(sub, return_inverse=True)
        most = torch.zeros(ids.shape, dtype=torch.int64, device=off.device)
        most.scatter_reduce_(0, inv, step_words, reduce="amax")
        sub_words = int(most.sum())
    n_tests = int(torch.unique(walk["tests"]).numel()) if tests else 0
    nbytes = n * (4 + 1 + 8) + sub_words * 4 + n_tests * 4 + nvalid * (20 + 8)
    n_sub = int(torch.unique(sub).numel()) if steps else 0
    old_ops = steps * (32 * 10 + 2 * 16 * 4 + 10)
    shape = (f"N={n} rows, {steps} LF steps (max {ix.sampling} per row) over {n_sub} "
             f"distinct sub-rows, {tests} indicator tests [the first design's count: "
             f"{old_ops} ops, {old_ops / H100_OPS_PER_S * 1e3:.5f} ms]")
    return nbytes, nops, shape, steps + tests


def library_fn(name, args):
    """One PyTorch call computing the same function, where there is one."""
    import torch

    if name == "probe_mass" and args["st"] is None:
        return None
    if name == "probe_mass":  # per-plan mass: one scatter_add over plan ids
        st = args["st"]
        P = args["thr"].numel()
        plan = st[4].to(torch.int64).clamp(0, P - 1)
        size = torch.where(args["valid"].bool(), st[2].to(torch.int64) & 0xFFFFFFFF, 0)
        zeros = torch.zeros((st.shape[1], P), dtype=torch.int64, device=st.device)
        return lambda: torch.scatter_add(zeros, 1, plan, size)
    if name == "gather_states":  # the row gather only (no cut, pad or mask)
        st, ridx = args["st"], args["ridx"].to(torch.int64)
        return lambda: torch.index_select(st, 1, ridx)
    if name != "compact":
        return None
    arrays, valid, F = args["arrays"], args["valid"], args["F"]
    R = arrays.shape[0]

    def library():  # stable sort on the validity key + gather
        order = torch.sort((valid == 0).to(torch.uint8), dim=-1, stable=True).indices
        idx = order[:, :F].unsqueeze(0).expand(R, -1, -1)
        return torch.gather(arrays, 2, idx)

    return library


def time_kernels(checker, launches, chain_rates):
    """Phase 12: the largest checked call of each kernel (and of each entry
    of `timing_keys`), timed, each beside the launch floor (one empty
    kernel timed the same way) and locate beside the chain yardstick (the
    rowgather phase's dependent reads, `chain_rates`: {row bytes: {lanes:
    reads/s}} from its 20 MB table); returns the kernels line's rows."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.index.fmindex import sub_width

    missing = [k for k in ("compact+count", "compact+short", "compact+long",
                           "count_tail+exact", "count_tail+fe1") if k not in checker.largest]
    if missing:
        raise AssertionError(f"no call was checked for {missing}")
    seen = {(v.split()[-1], "count=True" in v) for v in checker.variants["compact"]}
    unseen = {(r, c) for r in ("short", "middle", "long") for c in (False, True)} - seen
    if unseen:
        raise AssertionError(f"compact regimes (regime, count) never checked: {sorted(unseen)}")
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    log(f"kernel launch floor: {floor_ms:.4f} ms with L2 flushed (one empty kernel, "
        f"torch.cuda._sleep(0), timed as every kernel below)")
    rows = []
    extra = sorted(k for k in checker.largest if "+" in k)
    for key in NAMES + tuple(extra):
        name = key.split("+")[0]
        if key not in checker.largest:
            raise AssertionError(f"{key}: no call was checked")
        _size, args, phase = checker.largest[key]
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
        rate = ""
        if name == "locate":
            n = args["pos"].numel()
            steps = int(locate_walk(args["index"], args["pos"], args["valid"])["steps"].sum())
            rb = 4 * sub_width(args["index"].has_n)
            yard = ", ".join(f"{steps / r * 1e3:.4f} ms at {lanes} lane(s) ({r:.3e} reads/s)"
                             for lanes, r in sorted(chain_rates[rb].items()))
            rate = (f" located_rows_per_s={n / (ms * 1e-3):.3e} flushed; chain yardstick "
                    f"(not a bound: the rowgather phase's dependent {rb} B row reads "
                    f"from its 20 MB table, {steps} of them): {yard}")
        elif n_reads:
            rate = (f" rows_per_s={n_reads / (ms * 1e-3):.3e} flushed, "
                    f"{n_reads / (warm_ms * 1e-3):.3e} warm")
        calls = ("the largest of its variant" if key != name else
                 f"{checker.calls[name]} checked calls equal to plain (variants: "
                 f"{', '.join(sorted(checker.variants[name]))}); largest")
        log(f"kernel {key}: {calls}, "
            f"in {phase}: {shape}: {ms:.4f} ms with L2 flushed, {warm_ms:.4f} ms "
            f"warm (plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}: "
            f"{nbytes} B, {nops} ops"
            + (f", library {library_ms:.4f} ms" if library_ms is not None else "")
            + f", {ms / floor_ms:.2f}x the launch floor){rate}; launches {launches[name]}")
        if key != name:
            continue  # logged only: the kernels line has one entry per kernel
        rows.append(dict(
            name=name, route="cuda", source=f"genmap_tpu_torch/csrc/{kernels.KERNELS[name].source}",
            replaces=kernels.KERNELS[name].replaces, launches=launches[name],
            max_abs_err=checker.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        ))
    return rows


def time_seed_tables(idx):
    """K2 on the main path's index: the seed-table build (`with_seed_tables`,
    the seed_build kernel's launches) beside its bound, the launch floor and
    its peak allocated bytes, and the per-batch lookup (`initial_states`:
    one seed_lookup launch) at two batch sizes."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.cli.map_cmd import default_overlap
    from genmap_tpu_torch.index.fmindex import FMIndexData
    from genmap_tpu_torch.ops import rank
    from genmap_tpu_torch.search import engine as se
    from genmap_tpu_torch.search.schemes import plans_for

    data = FMIndexData.load(idx)
    index = rank.DeviceIndex.from_part(data, data.parts[0], light=True, device="cuda")
    text = rank.DeviceText.from_host(data, "cuda")
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    build_ms = device_ms(lambda: rank.with_seed_tables(index), reps=10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    built = rank.with_seed_tables(index)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = kernels.launch_counts()
    del built
    nbytes, nops, shape, _n = seed_build_work(dict(index=index, t0=index.seed_t0),
                                              (index.seed_mlo, index.seed_size))
    bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, nops / H100_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    x = min(default_overlap(K, E), min(K - 1, K - E - 2))
    o = K - x
    J = K - o + 1
    sched = se._InfixSchedule(plans_for(E, o), K - o, index.device)
    t_seed = se.seed_steps(index, sched, sched.T)
    Fp = int(se.infix_pool_schedule(plans_for(E, o), K - o, index.n_total, 1.0)[t_seed])
    rng = np.random.default_rng(SEED + 5)
    for B in (1024, 8192):
        starts = rng.integers(0, data.text_len - K - J, B).astype(np.uint32)
        needles = rank.extract_needles(
            text, torch.from_numpy(starts.view(np.int32)).to(index.device), K + J - 1,
            data.text_len)
        torch.cuda.synchronize()
        lookup_ms = device_ms(lambda: se.initial_states(index, sched, needles, t_seed, Fp,
                                                        index.n_total))
        t = time.perf_counter()
        for _ in range(10):
            se.initial_states(index, sched, needles, t_seed, Fp, index.n_total)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 100
        log(f"kernel seed tables (K2): lookup (seed_lookup) of t0={t_seed} levels for "
            f"B={B} blocks x P={sched.P} plans into Fp={Fp} slots: {lookup_ms:.4f} ms "
            f"device, {host_ms:.4f} ms wall per batch")
    others = {k: v for k, v in launches.items() if v and k != "seed_build"}
    if launches["seed_build"] <= 0 or others:
        raise AssertionError(f"the seed-table build launched {launches}")
    log(f"kernel seed tables (K2): build (seed_build) of t0={index.seed_t0} levels on "
        f"the {index.n_total}-symbol index ({shape}): {build_ms:.4f} ms device with L2 "
        f"flushed in {launches['seed_build']} launches ({build_ms / floor_ms:.2f}x the "
        f"launch floor of {floor_ms:.4f} ms; no other kernel launched); bound "
        f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B: tables written and distinct rank "
        f"sub-rows read; {nops} ops); peak allocated {peak} B above what was allocated "
        f"before (the tables are {4 * (index.seed_mlo.numel() + index.seed_size.numel())} B)")


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
    from genmap_tpu_torch.search.engine import DEFAULT_TIERS, BlockMapper, Tier

    t = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    seq = make_genomelike(DNA5_BP, seed=SEED + 1)
    for s in rng.integers(0, len(seq) - 2000, 40):  # N runs (Dna5)
        seq[s : s + int(rng.integers(10, 1500))] = 4
    ff = FastaFile(name="dna5.fa")
    ff.ids, ff.seqs = ["chrK"], [seq]
    data = build_index([ff], sampling=10)
    checker.on, checker.phase = True, "the Dna5 index's seed-table build"
    try:
        index = rank.DeviceIndex.from_part(data, data.parts[0], light=True, device=dev)
    finally:
        checker.on = False
    if not checker.calls["seed_build"]:
        raise AssertionError("the Dna5 index's seed-table build was not checked")
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
    log(f"dna5: dimer flagged sub-block fraction {data.parts[0].dimer_flag_frac:.5f} "
        f"(the automatic gate needs < 0.001)")
    # tier 0 as the engine runs it, and two forced dimer tiers
    for tier, names in ((DEFAULT_TIERS[0], NAMES[:4]),
                        (Tier(4, 4, 1, exact=False, dimer=True), ("dimer_step",)),
                        (Tier(32, 64, 8, dimer=True), ("dimer_step",))):
        mapper = BlockMapper(index, text, K=K, errors=E, overlap=o, J=J, B=B_DNA5,
                             tier=tier, cap=65535, rev_compl=True)
        before = dict(checker.calls)
        # the dimer calls are kept for timing (their A = 5 variants)
        checker.on, checker.keep = True, tier.dimer
        checker.phase = f"the Dna5 (100,2) B={B_DNA5} batch at {tier}"
        try:
            out = mapper(st_t, cnt, data.text_len)
            torch.cuda.synchronize()
        finally:
            checker.on = checker.keep = False
        n = {k: checker.calls[k] - before[k] for k in NAMES}
        log(f"dna5: one (100,2) B={B_DNA5} batch at {tier}: {int(out['overflow'].sum())} "
            f"blocks flagged to the next tier; kernel calls equal to plain {n}")
        if min(n[k] for k in names) == 0:
            raise AssertionError(f"the Dna5 batch did not call every kernel: {n}")


# ---------------------------------------------------------------------------
# phases 3-7: the main path through the CLI, cross-checks, CSV, dedup, -ep
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


class first_batches_checked:
    """While active, the first batch of every batch program an engine runs
    (the probe, each tier's calibration batch, each tier's fused program or
    phase-A collector, the dedup pre-pass) and of every phase-B extender
    (each rung and mode) is profiled (with `profile`) and then run with
    every kernel call held against its plain version."""

    def __init__(self, checker, where: str, profile: bool = False):
        self.checker, self.where, self.profile = checker, where, profile
        self.seen = set()

    def _first(self, label, call):
        """Profile (optionally) and then check one first batch."""
        checker = self.checker
        checker.on = False
        if self.profile:
            import torch

            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log(f"memory: {label}: peak allocated {peak} B ({peak - base} B above "
                f"what was allocated before the batch)")
            profile_batch(call, label)
        checker.on, checker.keep, checker.phase = True, True, label
        try:
            return call()
        finally:
            checker.on = checker.keep = False

    def __enter__(self):
        from genmap_tpu_torch.engine.mappability import MappabilityEngine
        from genmap_tpu_torch.search.engine import Extender

        self.orig = orig = MappabilityEngine._run_batch
        self.orig_ext = orig_ext = Extender.__call__
        checker, seen = self.checker, self.seen

        def run_batch(eng, runs, layout, bstarts, bcnts, B):
            key = tuple(id(r) for r in runs)
            if key in seen:
                checker.on = False
                return orig(eng, runs, layout, bstarts, bcnts, B)
            seen.add(key)
            run = runs[0]
            t = run.tier
            kind = ("the probe at " if run.probe else "the calibration batch at " if
                    run.with_occ else "phase A at " if run.collect_only else "")
            label = (f"{self.where}: first batch of {kind}"
                     f"tier(f_search={t.f_search}, "
                     f"f_extend={t.f_extend}, exact={t.exact}, dimer={t.dimer}, "
                     f"ext_exact={t.ext_exact}, K={run.K}, e={run.errors}"
                     f"{', with_exact' if run.with_exact else ''}) B={B} "
                     f"({len(bstarts)} blocks, {len(runs)} index part(s))")
            return self._first(label, lambda: orig(eng, runs, layout, bstarts, bcnts, B))

        def extend(run, starts, cnt, limit, phase_a, ridx, n):
            key = ("ext", run.Fe, run.tier.exact, run.tier.dimer)
            if key in seen:
                checker.on = False
                return orig_ext(run, starts, cnt, limit, phase_a, ridx, n)
            seen.add(key)
            label = (f"{self.where}: first phase-B batch at rung Fe={run.Fe}, "
                     f"{'exact' if run.tier.exact else 'fast'}-"
                     f"{'dimer' if run.tier.dimer else 'mono'} (B={starts.shape[0]}, "
                     f"{n} blocks, schedule {run.fe_sched}, with_occ={run.with_occ})")
            return self._first(label, lambda: orig_ext(run, starts, cnt, limit, phase_a,
                                                       ridx, n))

        MappabilityEngine._run_batch = run_batch
        Extender.__call__ = extend
        return self

    def __exit__(self, *exc):
        from genmap_tpu_torch.engine.mappability import MappabilityEngine
        from genmap_tpu_torch.search.engine import Extender

        MappabilityEngine._run_batch = self.orig
        Extender.__call__ = self.orig_ext
        self.checker.on = self.checker.keep = False


def checked_map(idx, out, checker) -> None:
    """The map with every kernel call of the seed-table build and of the
    first batch of each program held against its plain version; that batch
    is profiled first."""
    from genmap_tpu_torch.cli.map_cmd import map_main

    before = dict(checker.calls)
    t = time.perf_counter()
    report = {}
    with first_batches_checked(checker, "main", profile=True) as fb:
        checker.on, checker.phase = True, "the seed-table build"
        rc = map_main(["-I", idx, "-O", out + "/", "-K", str(K), "-E", str(E),
                       "-fl", "-r", "--device", "cuda"], report=report)
    if rc != 0:
        raise AssertionError(f"checked map exited {rc}")
    n = {k: checker.calls[k] - before[k] for k in NAMES}
    st = report["stats"]
    log(f"main: checked map ({len(fb.seen)} batch programs) in "
        f"{time.perf_counter() - t:.2f} s: kernel calls equal to plain {n}; "
        f"probe skipped {st['probe_skipped']} blocks")
    log(f"main: dimer tier 0 {st['dimer_tier']}; ladder {ladder_str(st['tiers'])}; "
        f"blocks per tier {st['tier_blocks']}")
    log_split(report, "main")
    counted = [v for v in checker.variants["compact"] if "count=True" in v]
    if n["probe_mass"] == 0 or n["dimer_step"] == 0:
        raise AssertionError("the main path ran no probe batch or no dimer twin")
    if not (n["seed_lookup"] and n["gather_states"] and counted):
        raise AssertionError("no seed_lookup, gather_states or counting compact call "
                             "was checked on the main path")
    if not report["tuned_pools"] or not st["phase_a_batches"] or not st["rung_batches"]:
        raise AssertionError("the main path ran no calibration or no split pipeline")


def log_split(report, where):
    """The calibrated pools, the extension schedules, and the split
    pipeline's phase-A batches and phase-B batches / blocks per (tier, rung,
    mode) of a map's report."""
    st = report["stats"]
    for key, (pools, fe) in report["tuned_pools"].items():
        log(f"{where}: calibration (K, e, o, dimer, f_extend, tier) {key}: pools "
            f"{pools}, f_extend {fe}")
    log(f"{where}: extension schedules {report['ext_sched']}")
    mode = {(False, False): "fast-mono", (False, True): "fast-dimer",
            (True, True): "exact-dimer", (True, False): "exact-mono"}
    rungs = "; ".join(
        f"tier {t} Fe={fe} {mode[(ex, di)]}: {st['rung_batches'][k]} batches, "
        f"{st['rung_blocks'][k]} blocks"
        for k in sorted(st["rung_batches"]) for t, fe, ex, di in [k])
    log(f"{where}: split pipeline: {st['phase_a_batches']} phase-A batches, "
        f"{sum(st['rung_batches'].values())} phase-B batches ({rungs or 'none'})")


def ladder_str(tiers) -> str:
    """The expanded tier ladder, one f_search/f_extend[d][x] per tier
    (d: dimer rows, x: exact infix)."""
    return " ".join(f"{i}:{t.f_search}/{t.f_extend}{'d' if t.dimer else ''}"
                    f"{'x' if t.exact else ''}" for i, t in enumerate(tiers))


def counted_map(argv, report=None, mesh=None):
    """`genmap-tpu-torch map argv` (on `mesh` where given) with the launch
    counters set to 0 just before and read just after; returns the
    counts."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.cli.map_cmd import map_main

    kernels.reset_launches()
    rc = map_main(argv, report=report, mesh=mesh)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"genmap-tpu-torch map {' '.join(argv)} exited {rc}")
    return counts


# second grids of one wrapper call: their device time adds to the call's
SECOND_GRIDS = ("compact_long_write_kernel",)


def kernel_symbols() -> dict:
    """Each `__global__` function of csrc/ -> the kernel whose source holds it."""
    import re

    from genmap_tpu_torch import kernels

    out = {}
    for name, k in kernels.KERNELS.items():
        with open(k.source_path) as f:
            # the name before the parameter list, after any launch bounds
            # (written out or through a macro)
            for sym in re.findall(r"__global__\s+void\s+(?:\w+(?:\([^)]*\))?\s+)?(\w+)\s*\(",
                                  f.read()):
                out[sym] = name
    return out


def profiled_device_times(run):
    """run() under torch.profiler, device activity only.  Returns its wall
    seconds (to a synchronize), each port kernel's device ms per call (a
    call's grids summed), each kernel symbol's grids and ms, and the ms and
    count of every other device op (PyTorch's own kernels, copies, fills)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    syms = kernel_symbols()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    calls, by_sym, other_ms, n_other = {}, {}, 0.0, 0
    evs = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    for ev in evs:
        m = re.match(r"(?:void\s+)?(\w+)", ev.name)
        sym = m.group(1) if m else ev.name
        ms = ev.time_range.elapsed_us() / 1e3
        name = syms.get(sym)
        if name is None:
            other_ms += ms
            n_other += 1
            continue
        n, t_ = by_sym.get(sym, (0, 0.0))
        by_sym[sym] = (n + 1, t_ + ms)
        if sym in SECOND_GRIDS and calls.get(name):
            calls[name][-1] += ms
        else:
            calls.setdefault(name, []).append(ms)
    return wall, calls, by_sym, other_ms, n_other


def device_time_map(idx, work, k: int, e: int, want_freq, want_launches):
    """One more `map -K k -E e` of the main genome (not a timed run) under
    torch.profiler, device activity only: for each kernel of the port its
    launches, its device ms over the whole map (by grid where it has
    several), and the median and p90 device ms of one call; beside them the
    device time of everything else the map ran on the card.  Frequencies
    and launch counts must equal the counted runs'.  Returns {kernel:
    numbers} and the totals."""
    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.cli.map_cmd import map_main

    out = os.path.join(work, f"devtime_{k}_{e}")
    os.makedirs(out)
    report = {}
    argv = ["-I", idx, "-O", out + "/", "-K", str(k), "-E", str(e), "-fl", "-r",
            "--device", "cuda"]
    rcs = []
    kernels.reset_launches()
    t = time.perf_counter()
    wall, calls, by_sym, other_ms, n_other = profiled_device_times(
        lambda: rcs.append(map_main(argv, report=report)))
    read_s = time.perf_counter() - t - wall
    counts = kernels.launch_counts()
    if rcs != [0]:
        raise AssertionError(f"profiled map -K {k} -E {e} exited {rcs}")
    freq = np.fromfile(os.path.join(out, "yeastlike.genmap.freq16"), dtype="<u2")
    if not np.array_equal(freq, want_freq) or counts != want_launches:
        raise AssertionError(f"profiled ({k},{e}) map differs from the counted runs")
    syms = kernel_symbols()
    res = {}
    for name in sorted(calls, key=lambda n: -sum(calls[n])):
        per = np.asarray(calls[name])
        grids = {s: v for s, v in by_sym.items() if syms[s] == name}
        res[name] = dict(launches=counts[name], calls=len(per), ms_per_map=float(per.sum()),
                         median_ms=float(np.median(per)), p90_ms=float(np.percentile(per, 90)),
                         grids={s: dict(n=n, ms=ms) for s, (n, ms) in grids.items()})
        split = ("; by grid " + ", ".join(f"{s} {n}x {ms:.3f} ms" for s, (n, ms) in grids.items())
                 if len(grids) > 1 else "")
        log(f"devtime: ({k},{e}) {name}: {counts[name]} launches, {len(per)} calls traced, "
            f"{per.sum():.3f} ms device per map, per call median {np.median(per):.4f} ms "
            f"p90 {np.percentile(per, 90):.4f} ms{split}")
    port_ms = sum(r["ms_per_map"] for r in res.values())
    log(f"devtime: ({k},{e}) port kernels {port_ms:.3f} ms device per map; PyTorch's own "
        f"kernels, copies and fills {other_ms:.3f} ms in {n_other} device ops; map "
        f"compute {report['compute_s']:.3f} s, wall {wall:.3f} s (profiled); trace read "
        f"in {read_s:.1f} s")
    if not res:
        log(f"devtime: ({k},{e}) device time not measured (the trace holds no kernel)")
    return dict(kernels=res, port_ms=port_ms, other_ms=other_ms, other_ops=n_other,
                compute_s=report["compute_s"])


def read_tree(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as f:
            out[fn] = f.read()
    return out


def main_path(dev, work, checker):
    import torch

    from genmap_tpu_torch.cli.main import main as cli_main
    from genmap_tpu_torch.index.fmindex import FMIndexData

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
        t = time.perf_counter()
        counts = counted_map(["-I", idx, "-O", gout + "/", "-K", str(K), "-E", str(E),
                              "-fl", "-r", "--device", "cuda"], report=report)
        wall = time.perf_counter() - t
        missing = [n for n in MAIN_NAMES if counts[n] <= 0]
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
            f"{st['batches']} batches ({st['phase_a_batches']} phase A, "
            f"{sum(st['rung_batches'].values())} phase B); "
            f"peak allocated {torch.cuda.max_memory_allocated()} B")
    log(f"main: host load average after the timed runs {os.getloadavg()}")
    log(f"main: device bytes resident (index + text + seed tables) "
        f"{report['resident_bytes']}; probe skipped {st['probe_skipped']} blocks; "
        f"residual blocks per tier {st['tier_blocks']}, batches {st['batches']}, "
        f"escalated blocks {st['overflow_blocks']}")
    log(f"main: kernel launches per run {launches}")
    if not (gpu_freq[: len(chroms[0][1]) - K + 1] >= 1).all():
        raise AssertionError("a k-mer without N has frequency 0 (its own occurrence)")
    data = FMIndexData.load(idx)
    log(f"main: dimer flagged sub-block fraction {data.parts[0].dimer_flag_frac:.6f}; "
        f"dimer tier 0 {st['dimer_tier']}; ladder {ladder_str(st['tiers'])}")
    short, short_freq = short_map(idx, work, checker)
    short["device_per_map"] = device_time_map(idx, work, 24, 1, short_freq,
                                              short["launches"])
    devtime = device_time_map(idx, work, K, E, gpu_freq, launches)
    summary = dict(kmers_per_s_median=float(np.median(runs)), kmers_per_s_runs=runs,
                   n_kmers=report["n_kmers"], resident_bytes=report["resident_bytes"],
                   probe_skipped=st["probe_skipped"], tier_blocks=st["tier_blocks"],
                   device_per_map=devtime, map_24_1=short)
    ref = {(K, E): (gpu_freq, launches), (24, 1): (short_freq, short["launches"])}
    return launches, summary, idx, chroms, gpu_freq, ref


def short_map(idx, work, checker):
    """`map -K 24 -E 1` of the whole genome: its pool schedule is wide enough
    (mean >= 12 slots) that tier 0 runs on the dimer rows.  A checked run,
    then a counted one."""
    import torch

    from genmap_tpu_torch.cli.map_cmd import map_main

    argv = ["-K", "24", "-E", "1", "-fl", "-r", "--device", "cuda"]
    out = os.path.join(work, "short_checked")
    os.makedirs(out)
    report = {}
    before = dict(checker.calls)
    with first_batches_checked(checker, "main (24,1)") as fb:
        if map_main(["-I", idx, "-O", out + "/", *argv], report=report) != 0:
            raise AssertionError("checked (24,1) map failed")
    n = {k: checker.calls[k] - before[k] for k in NAMES}
    checked = np.fromfile(os.path.join(out, "yeastlike.genmap.freq16"), dtype="<u2")
    out = os.path.join(work, "short_counted")
    os.makedirs(out)
    torch.cuda.reset_peak_memory_stats()
    report = {}
    counts = counted_map(["-I", idx, "-O", out + "/", *argv], report=report)
    st = report["stats"]
    kps = report["n_kmers"] / report["compute_s"]
    freq = np.fromfile(os.path.join(out, "yeastlike.genmap.freq16"), dtype="<u2")
    log_split(report, "main (24,1)")
    log(f"main: map -K 24 -E 1: checked run ({len(fb.seen)} batch programs): kernel "
        f"calls equal to plain {n}; counted run {report['compute_s']:.2f} s compute, "
        f"{kps:.1f} k-mers/s, dimer tier 0 {st['dimer_tier']}, ladder "
        f"{ladder_str(st['tiers'])}, blocks per tier {st['tier_blocks']}, probe "
        f"skipped {st['probe_skipped']}, launches {counts}, peak allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    if not st["dimer_tier"] or counts["dimer_step"] == 0 or n["dimer_step"] == 0:
        raise AssertionError("the (24,1) map did not run tier 0 on the dimer rows")
    if not np.array_equal(freq, checked):
        raise AssertionError("(24,1) counted run's frequencies differ from the checked run's")
    return dict(kmers_per_s=kps, tier_blocks=st["tier_blocks"], launches=counts), freq


def check_phase(work, idx, chroms, gpu_freq, checker):
    """Phase 4: `map -d` of a BED selection on the CPU and, checked call by
    call, on the card; frequencies against the main path's, files against
    each other."""
    from genmap_tpu_torch.cli.map_cmd import map_main
    from genmap_tpu_torch.ops import rank

    wins, cum = selection(chroms, gpu_freq)
    bed = os.path.join(work, "sel.bed")
    with open(bed, "w") as f:
        for name, b, e, _ci in wins:
            f.write(f"{name}\t{b}\t{e}\n")
    mask = np.zeros(len(gpu_freq), bool)
    for _name, b, e, ci in wins:
        mask[cum[ci] + b : cum[ci] + e] = True
    trees = {}
    build = rank.with_seed_tables

    def seed_tables(index, t0=None):  # checked, not kept for timing: not a batch call
        checker.keep = False
        try:
            return build(index, t0)
        finally:
            checker.keep = True

    rank.with_seed_tables = seed_tables
    try:
        # with -d (fused per-tier programs), then without (the split pipeline:
        # a BED selection skips dedup, J = 50, one index part)
        for csv, dev in ((True, "cpu"), (True, "cuda"), (False, "cpu"), (False, "cuda")):
            what = "-d map" if csv else "map without -d"
            out = os.path.join(work, f"sel_{dev}_{int(csv)}")
            os.makedirs(out)
            t = time.perf_counter()
            report = {}
            checker.on, checker.keep = dev == "cuda", True
            checker.phase = f"the selection's {what}"
            try:
                rc = map_main(["-I", idx, "-O", out + "/", "-K", str(K), "-E", str(E),
                               "-fl", "-r", *(["-d"] if csv else []), "-S", bed,
                               "--device", dev], report=report)
            finally:
                checker.on = checker.keep = False
            if rc != 0:
                raise AssertionError(f"{dev} {what} exited {rc}")
            trees[(dev, csv)] = read_tree(out)
            st = report["stats"]
            log(f"check: {what} of the selection on {dev} in "
                f"{time.perf_counter() - t:.1f} s (tier blocks {st['tier_blocks']}, "
                f"{st['phase_a_batches']} phase-A and {sum(st['rung_batches'].values())} "
                f"phase-B batches)")
            if not csv and not st["phase_a_batches"]:
                raise AssertionError("the selection without -d ran no split pipeline")
    finally:
        rank.with_seed_tables = build
    nsel = int(mask.sum())
    res = dict(kmers=nsel)
    for csv in (True, False):
        cpu, card = trees[("cpu", csv)], trees[("cuda", csv)]
        what = "-d" if csv else "no -d"
        freqs = {d: np.frombuffer(trees[(d, csv)]["yeastlike.genmap.freq16"], dtype="<u2")
                 for d in ("cpu", "cuda")}
        bad = sum(int((f[mask] != gpu_freq[mask]).sum()) for f in freqs.values())
        same = [fn for fn in cpu if cpu[fn] == card.get(fn)]
        log(f"check ({what}): {nsel} k-mers in {len(wins)} windows "
            f"({(gpu_freq[mask] > 1).sum()} with frequency > 1, max "
            f"{gpu_freq[mask].max()}): {bad} mismatches of the CPU's and the card's "
            f"against the main path; CPU and card files {sorted(cpu)}, byte-equal: "
            f"{same}" + (f" (csv {len(cpu['yeastlike.genmap.csv'])} B)" if csv else ""))
        if nsel < 20_000 or bad:
            raise AssertionError(f"cross-check ({what}) failed: {nsel} k-mers, "
                                 f"{bad} mismatches")
        if sorted(cpu) != sorted(card) or len(same) != len(cpu):
            raise AssertionError(f"CPU and card output files ({what}) differ")
        res["mismatches" if csv else "mismatches_no_d"] = bad
    return res


def csv_phase(work, idx, chroms, gpu_freq):
    """Phase 5: `map -d` of all of chrI on the card."""
    from genmap_tpu_torch.engine.mappability import MappabilityEngine

    name, codes = chroms[0]
    nk = len(codes) - K + 1
    bed = os.path.join(work, "chrI.bed")
    with open(bed, "w") as f:
        f.write(f"{name}\t0\t{nk}\n")
    out = os.path.join(work, "csv_chrI")
    os.makedirs(out)
    orig = MappabilityEngine.locate_many
    located = [0, 0.0]

    def timed_locate(eng, pi, positions):
        t = time.perf_counter()
        res = orig(eng, pi, positions)  # the host copy of the result waits for the card
        located[0] += len(positions)
        located[1] += time.perf_counter() - t
        return res

    MappabilityEngine.locate_many = timed_locate
    report = {}
    t = time.perf_counter()
    try:
        counts = counted_map(["-I", idx, "-O", out + "/", "-K", str(K), "-E", str(E),
                              "-fl", "-r", "-d", "-S", bed, "--device", "cuda"], report)
    finally:
        MappabilityEngine.locate_many = orig
    wall = time.perf_counter() - t
    freq = np.fromfile(os.path.join(out, "yeastlike.genmap.freq16"), dtype="<u2")
    bad = int((freq[:nk] != gpu_freq[:nk]).sum())
    csv_bytes = os.path.getsize(os.path.join(out, "yeastlike.genmap.csv"))
    log(f"csv: map -d of {name} ({nk} k-mers) on the card in {wall:.2f} s "
        f"({report['compute_s']:.2f} s compute): {located[0]} SA rows located in "
        f"{located[1]:.3f} s of locate calls ({located[0] / max(located[1], 1e-9):.4e} "
        f"located rows/s, host copy included); csv {csv_bytes} B; launches {counts}; "
        f"{bad} frequency mismatches against the main path")
    if bad:
        raise AssertionError(f"-d frequencies differ from the main path's on {name}")
    missing = [n for n in ("extract_needles", "candidate_step", "compact", "count_tail",
                           "locate") if counts[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the -d map: {missing}")
    return counts, dict(kmers=nk, located_rows=located[0], locate_s=located[1])


def dedup_phase(dev, checker):
    """Phase 6: chrI-chrIV twice in one file, dedup on against off."""
    from genmap_tpu_torch.cli.map_cmd import default_overlap
    from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
    from genmap_tpu_torch.index.build import build_index
    from genmap_tpu_torch.io.fasta import FastaFile
    from genmap_tpu_torch.search.engine import infix_pool_schedule
    from genmap_tpu_torch.search.schemes import plans_for

    chroms = yeast_like_genome()[:DEDUP_CHROMS]
    ff = FastaFile(name="dup.fa")
    ff.ids = [n for n, _ in chroms] + [f"{n}_copy" for n, _ in chroms]
    ff.seqs = [c for _, c in chroms] * 2
    t = time.perf_counter()
    data = build_index([ff], sampling=10)
    log(f"dedup: {data.text_len} bp index (chrI-chrIV twice) built in "
        f"{time.perf_counter() - t:.2f} s")
    orig = MappabilityEngine._compute_with_dedup
    taken = []

    def spy(self, *a, **kw):
        taken.append(orig(self, *a, **kw))
        return taken[-1]

    out = {}
    for k, e in ((K, E), (24, 1)):
        x = min(default_overlap(k, e), min(k - 1, k - e - 2))
        params = SearchParams(length=k, overlap=k - x)
        freqs = {}
        for dedup in (True, False):
            eng = MappabilityEngine(data, batch_blocks=1024, batch_kmers=50000,
                                    dedup=dedup, light=True, device=dev)
            lay = eng.layouts[0]
            if dedup:
                # The engine's gate estimates the duplicate share from 2^19
                # sampled k-mers, counting repeats WITHIN the sample: for a
                # genome of two copies that reads ~2^19 / n (~0.05 here), and
                # the gate (>= 0.15 / 0.3) would decline.  Give it this
                # construction's known share, 0.5, and log the estimate.
                est = eng._sampled_dup_rate(data.decode_slice(lay.start, lay.length),
                                            k, lay.length - k + 1)
                eng._dup_rate_cache[(lay.start, lay.length, k)] = 0.5
                log(f"dedup: ({k},{e}): sampled duplicate share {est:.4f}, "
                    f"gate given the known 0.5")
            taken.clear()
            t = time.perf_counter()
            MappabilityEngine._compute_with_dedup = spy
            try:
                with first_batches_checked(checker, f"dedup ({k},{e}) dedup={dedup}"):
                    freqs[dedup] = eng.compute_file(lay, params, e, 65535).c
            finally:
                MappabilityEngine._compute_with_dedup = orig
            s_ = eng.stats
            pool_mean = float(infix_pool_schedule(
                plans_for(e, k - x), x, data.parts[0].n_total).mean())
            log(f"dedup: ({k},{e}) dedup={dedup}: {time.perf_counter() - t:.2f} s, "
                f"dedup pass taken {taken}, probe skipped {s_['probe_skipped']}, "
                f"tier blocks {s_['tier_blocks']}, batches {s_['batches']}; dimer "
                f"tier 0 {s_['dimer_tier']} (tier-0 pool mean {pool_mean:.2f}, gate 12; "
                f"flagged fraction {data.parts[0].dimer_flag_frac:.6f}), ladder "
                f"{ladder_str(s_['tiers'])}")
            if s_["dimer_tier"] != (pool_mean >= 12.0 and eng._dimer_ok):
                raise AssertionError(f"({k},{e}): dimer tier 0 {s_['dimer_tier']} "
                                     "against the gate")
            if taken != ([True] if dedup else []):
                raise AssertionError(f"({k},{e}) dedup={dedup}: dedup pass {taken}")
        bad = int((freqs[True] != freqs[False]).sum())
        dup = float((freqs[True][: data.text_len // 2 - k] >= 2).mean())
        log(f"dedup: ({k},{e}): {bad} mismatches dedup on vs off; "
            f"{dup:.4f} of the first copy's k-mers have frequency >= 2")
        if bad:
            raise AssertionError(f"({k},{e}): dedup changes frequencies")
        out[f"{k},{e}"] = dict(mismatches=bad)
    if checker.calls["count_tail"] == 0 or "count_tail+exact" not in checker.largest:
        raise AssertionError("no zero-error count_tail call was checked")
    return out


def ep_phase(work):
    """Phase 7: exclude-pseudo over a directory of two FASTA files."""
    from genmap_tpu_torch.cli.main import main as cli_main
    from genmap_tpu_torch.cli.map_cmd import map_main

    rng = np.random.default_rng(SEED + 3)
    base = yeast_like_genome()[:3]
    fdir = os.path.join(work, "ep_fasta")
    os.makedirs(fdir)
    write_fasta(os.path.join(fdir, "a.fa"), [(f"{n}_A", c) for n, c in base])
    mutated = []
    for n, c in base:
        c = c.copy()
        sub = rng.random(len(c)) < 0.01
        c[sub] = (c[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        mutated.append((f"{n}_B", c))
    write_fasta(os.path.join(fdir, "b.fa"), mutated)
    idx = os.path.join(work, "ep_idx")
    t = time.perf_counter()
    if cli_main(["index", "-FD", fdir, "-I", idx]) != 0:
        raise AssertionError("genmap-tpu-torch index -FD failed")
    log(f"ep: index of {EP_BP} bp x 2 files built in {time.perf_counter() - t:.2f} s")
    nk = len(base[0][1]) - K + 1
    full = os.path.join(work, "ep_chrI.bed")
    with open(full, "w") as f:
        f.write(f"chrI_A\t0\t{nk}\nchrI_B\t0\t{nk}\n")
    sub = os.path.join(work, "ep_sub.bed")
    with open(sub, "w") as f:
        for name in ("chrI_A", "chrI_B"):
            for b in np.linspace(0, nk - 1000, 5).astype(int):
                f.write(f"{name}\t{b}\t{b + 1000}\n")
    flags = ["-K", str(K), "-E", str(E), "-ep", "-d", "-fl", "-r"]
    out = os.path.join(work, "ep_full")
    os.makedirs(out)
    t = time.perf_counter()
    counts = counted_map(["-I", idx, "-O", out + "/", *flags, "-S", full,
                          "--device", "cuda"])
    fa = np.fromfile(os.path.join(out, "a.genmap.freq16"), dtype="<u2")[:nk]
    hist = np.bincount(fa, minlength=3)
    log(f"ep: map -ep -d of chrI of both files on the card in "
        f"{time.perf_counter() - t:.2f} s; launches {counts}; file A chrI distinct-file "
        f"counts 0/1/2: {hist[:3].tolist()}")
    if counts["locate"] <= 0 or fa.max() > 2 or hist[2] == 0:
        raise AssertionError(f"-ep map of chrI: launches {counts}, counts {hist.tolist()}")
    trees = {}
    for dev in ("cuda", "cpu"):
        o = os.path.join(work, f"ep_sub_{dev}")
        os.makedirs(o)
        t = time.perf_counter()
        if map_main(["-I", idx, "-O", o + "/", *flags, "-S", sub, "--device", dev]) != 0:
            raise AssertionError(f"-ep map of the sub-selection on {dev} failed")
        trees[dev] = read_tree(o)
        log(f"ep: sub-selection (10 x 1000 k-mers) on {dev} in "
            f"{time.perf_counter() - t:.1f} s")
    same = sorted(fn for fn in trees["cpu"] if trees["cpu"][fn] == trees["cuda"].get(fn))
    log(f"ep: CPU and card files {sorted(trees['cpu'])}, byte-equal: {same}")
    if sorted(trees["cpu"]) != sorted(trees["cuda"]) or len(same) != len(trees["cpu"]):
        raise AssertionError("CPU and card -ep output files differ")
    return dict(chrI_counts=hist[:3].tolist(), sub_kmers=10_000)


def multipart_phase(work, checker):
    """Phase 8: chrI-chrVII indexed whole and split into three parts."""
    from genmap_tpu_torch.cli.main import main as cli_main
    from genmap_tpu_torch.cli.map_cmd import map_main
    from genmap_tpu_torch.index.fmindex import FMIndexData

    chroms = yeast_like_genome()[:MP_CHROMS]
    fa = os.path.join(work, "mp.fa")
    write_fasta(fa, chroms)
    idx = {}
    for name, extra in (("whole", []), ("split", ["-xm", str(MP_XM)])):
        idx[name] = os.path.join(work, f"mp_{name}")
        t = time.perf_counter()
        if cli_main(["index", "-F", fa, "-I", idx[name], *extra]) != 0:
            raise AssertionError(f"genmap-tpu-torch index ({name}) failed")
        parts = FMIndexData.load(idx[name]).parts
        log(f"multipart: {name} index of {sum(len(c) for _, c in chroms)} bp built in "
            f"{time.perf_counter() - t:.2f} s: {len(parts)} part(s) of "
            f"{[p.n_total for p in parts]} symbols, dimer flagged fractions "
            f"{[round(p.dimer_flag_frac, 6) for p in parts]}")
    if len(FMIndexData.load(idx["split"]).parts) < 3:
        raise AssertionError("the -xm index has fewer than 3 parts")
    # each part's seed tables at the depth a part mesh gives them all (the
    # smallest part's), checked against the plain build like every other
    from genmap_tpu_torch.ops import rank

    data = FMIndexData.load(idx["split"])
    shared = min(rank.seed_depth(int(p.n_total)) for p in data.parts)
    before = checker.calls["seed_build"]
    checker.on, checker.phase = True, "the multipart parts' seed tables at the shared depth"
    try:
        for p in data.parts:
            rank.DeviceIndex.from_part(data, p, light=True, device="cuda", seed_t0=shared)
    finally:
        checker.on = False
    n = checker.calls["seed_build"] - before
    if n != len(data.parts):
        raise AssertionError(f"{n} of {len(data.parts)} shared-depth builds checked")
    log(f"multipart: seed tables of the {len(data.parts)} parts at the shared depth "
        f"{shared} (own depths {[rank.seed_depth(int(p.n_total)) for p in data.parts]}) "
        f"equal to the plain build")

    def freq_of(out):
        return np.fromfile(os.path.join(out, "mp.genmap.freq16"), dtype="<u2")

    out, whole = {}, {}
    for k, e in ((K, E), (24, 1)):
        freqs = {}
        for name in ("whole", "split"):
            o = os.path.join(work, f"mp_{name}_{k}_{e}")
            os.makedirs(o)
            report = {}
            before = dict(checker.calls)
            t = time.perf_counter()
            with first_batches_checked(checker, f"multipart {name} ({k},{e})"):
                counts = counted_map(["-I", idx[name], "-O", o + "/", "-K", str(k), "-E",
                                      str(e), "-fl", "-r", "--device", "cuda"], report)
            n = {x: checker.calls[x] - before[x] for x in NAMES}
            st = report["stats"]
            freqs[name] = freq_of(o)
            log(f"multipart: ({k},{e}) {name}: {time.perf_counter() - t:.2f} s "
                f"({report['compute_s']:.2f} s compute, first batches checked); "
                f"resident bytes per part {report['part_bytes']} ({report['resident_bytes']} "
                f"B in all, with the text); dimer tier 0 {st['dimer_tier']}, "
                f"ladder {ladder_str(st['tiers'])}, blocks per tier {st['tier_blocks']}, "
                f"probe skipped {st['probe_skipped']}; launches {counts}; checked calls {n}")
            log_split(report, f"multipart ({k},{e}) {name}")
        bad = int((freqs["whole"] != freqs["split"]).sum())
        log(f"multipart: ({k},{e}): {bad} frequency mismatches whole vs split")
        if bad or freqs["whole"].shape[0] != sum(len(c) for _, c in chroms):
            raise AssertionError(f"multipart ({k},{e}): whole and split differ")
        out[f"{k},{e}"] = dict(mismatches=bad)
        whole[(k, e)] = read_tree(os.path.join(work, f"mp_whole_{k}_{e}"))
    acc_calls = [v for v in checker.variants["probe_mass"] if "acc=True" in v]
    if not acc_calls:
        raise AssertionError("no probe_mass accumulate call was checked")

    # -d of a selection: card vs CPU on the split index, split vs whole
    nk = len(chroms[0][1]) - K + 1
    bed = os.path.join(work, "mp_sel.bed")
    per = MP_SEL // (2 * len(chroms)) + 1
    with open(bed, "w") as f:
        for name, c in chroms:
            for b in np.linspace(0, len(c) - K - per, 2).astype(int):
                f.write(f"{name}\t{b}\t{b + per}\n")
    trees = {}
    for name, dev in (("split", "cuda"), ("split", "cpu"), ("whole", "cuda")):
        o = os.path.join(work, f"mp_sel_{name}_{dev}")
        os.makedirs(o)
        t = time.perf_counter()
        checker.on, checker.phase = dev == "cuda", f"multipart -d selection ({name})"
        try:
            rc = map_main(["-I", idx[name], "-O", o + "/", "-K", str(K), "-E", str(E),
                           "-fl", "-r", "-d", "-S", bed, "--device", dev])
        finally:
            checker.on = False
        if rc != 0:
            raise AssertionError(f"-d map of the selection ({name}, {dev}) failed")
        trees[(name, dev)] = read_tree(o)
        log(f"multipart: -d selection ({2 * len(chroms) * per} k-mers) on the {name} "
            f"index on {dev} in {time.perf_counter() - t:.1f} s")
    ref = trees[("split", "cuda")]
    for key, tree in trees.items():
        same = sorted(fn for fn in ref if ref[fn] == tree.get(fn))
        log(f"multipart: files of {key} byte-equal to the split index's on the card: {same}")
        if sorted(tree) != sorted(ref) or len(same) != len(ref):
            raise AssertionError(f"-d files of {key} differ")
    csv = ref["mp.genmap.csv"].decode()
    if csv.count("\n") < 2 * len(chroms) * per or nk <= 0:
        raise AssertionError("-d selection: too few CSV rows")
    out["selection_kmers"] = 2 * len(chroms) * per
    # the single-GPU outputs the mesh phase compares with
    refs = dict(fa=fa, split=idx["split"], bed=bed, trees=whole,
                sel=trees[("whole", "cuda")])
    return out, refs


# ---------------------------------------------------------------------------
# phases 9-10: the map on rank meshes (torch.distributed)
# ---------------------------------------------------------------------------

MESH_XM = 6_000_000  # -xm of the mesh phase: chrI-chrVII in exactly two parts
COLLECTIVES = ("all_reduce", "all_gather", "broadcast")


def timed_collectives(run):
    """run() with the host time inside every torch.distributed collective
    call summed (perf_counter around each call); returns (run's result,
    host ms)."""
    import torch.distributed as dist

    host, orig = [0.0], {}
    for name in COLLECTIVES:
        fn = orig[name] = getattr(dist, name)

        def timed(*a, _fn=fn, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                host[0] += time.perf_counter() - t

        setattr(dist, name, timed)
    try:
        return run(), host[0] * 1e3
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)


def nccl_device_ms(run):
    """run() under torch.profiler; returns the device time of the NCCL
    kernels in its trace (None when it holds none) and their count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev, n = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and "nccl" in ev.key.lower():
            dev += (getattr(ev, "self_device_time_total", 0)
                    or getattr(ev, "self_cuda_time_total", 0)) / 1e3
            n += ev.count
    return (dev if n else None), n


def mesh_map(idx, out, k, e, mesh, extra=(), report=None):
    """`map -K k -E e` of `idx` on `mesh` through map_main, counted."""
    os.makedirs(out, exist_ok=True)
    return counted_map(["-I", idx, "-O", out + "/", "-K", str(k), "-E", str(e), "-fl",
                        "-r", *extra, "--device", "cuda"], report=report, mesh=mesh)


def mesh1_phase(work, idx, ref, checker):
    """Phase 9: data_mesh(1) and part_data_mesh(1, 1) maps of the main
    genome in a NCCL world of one rank (this process, cuda:0): a counted
    run (k-mers/s, collectives, host time in their calls), at (100,2) a
    profiled run (NCCL device time), and a second counted run; the part
    mesh's (100,2) map first with its first batches checked; frequencies
    equal to the single-GPU maps'."""
    import torch.distributed as dist

    from genmap_tpu_torch.parallel.mesh import data_mesh
    from genmap_tpu_torch.parallel.partmesh import part_data_mesh

    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(work, "mesh1"), 1),
                            rank=0, world_size=1)
    res = {}
    try:
        for kind, make in (("data(1)", data_mesh), ("part(1) x data(1)",
                                                    lambda n: part_data_mesh(1, n))):
            for (k, e), (want, ref_counts) in ref.items():
                mesh = make(1)
                what = f"mesh1 {kind} ({k},{e})"
                t = time.perf_counter()
                checked = 0
                if kind.startswith("part") and k == K:
                    # the programs only a mesh runs: the part mapper's
                    # merges, the part prober and its reduced decision
                    with first_batches_checked(checker, what) as fb:
                        mesh_map(idx, os.path.join(work, f"m1c_{kind[:4]}_{k}"), k, e,
                                 mesh)
                    checked = len(fb.seen)
                t_check = time.perf_counter() - t
                c0, b0 = mesh.collectives, mesh.wire_bytes
                report = {}
                out = os.path.join(work, f"m1_{kind[:4]}_{k}")
                counts, host_ms = timed_collectives(
                    lambda: mesh_map(idx, out, k, e, mesh, report=report))
                st = report["stats"]
                ncoll, nbytes = mesh.collectives - c0, mesh.wire_bytes - b0
                t = time.perf_counter()
                coll_ms, n_nccl = None, 0
                if k == K:  # the profiler costs 30-50 s a map: (100,2) only
                    coll_ms, n_nccl = nccl_device_ms(lambda: mesh_map(
                        idx, os.path.join(work, f"m1t_{kind[:4]}_{k}"), k, e, mesh))
                t_prof = time.perf_counter() - t
                report2 = {}
                mesh_map(idx, os.path.join(work, f"m1r_{kind[:4]}_{k}"), k, e, mesh,
                         report=report2)
                kps2 = report2["n_kmers"] / report2["compute_s"]
                freq = np.fromfile(os.path.join(out, "yeastlike.genmap.freq16"), dtype="<u2")
                bad = int((freq != want).sum()) if freq.shape == want.shape else -1
                kps = report["n_kmers"] / report["compute_s"]
                need = [n for n in MAIN_NAMES if ref_counts[n] > 0 and n != "gather_states"]
                missing = [n for n in need if counts[n] <= 0]
                bound_ms = nbytes / H100_BYTES_PER_S * 1e3
                log(f"mesh1: {kind} ({k},{e}): {bad} frequency mismatches against the "
                    f"single-GPU map; {kps:.1f} k-mers/s ({report['compute_s']:.2f} s "
                    f"compute); {st['batches']} batches, {ncoll} collectives "
                    f"({ncoll / max(1, st['batches']):.2f} per batch), {nbytes} B in and "
                    f"out of them ({nbytes / max(1, st['batches']):.0f} B per batch), "
                    f"host time in the collective calls {host_ms:.1f} ms; in a profiled "
                    f"map {n_nccl} NCCL kernels, device time "
                    f"{'not measured' if coll_ms is None else f'{coll_ms:.4f} ms'} (bound "
                    f"{bound_ms:.5f} ms by bytes); a second counted run {kps2:.1f} k-mers/s; "
                    f"{checked} batch programs checked ({t_check:.1f} s), profiled run "
                    f"{t_prof:.1f} s; "
                    f"blocks per tier {st['tier_blocks']}, probe skipped "
                    f"{st['probe_skipped']}, ladder {ladder_str(st['tiers'])}, "
                    f"split pipeline {st['phase_a_batches']} phase-A batches; "
                    f"launches {counts}")
                if bad or missing:
                    raise AssertionError(f"{what}: {bad} mismatches, kernels not "
                                         f"launched {missing}")
                res[f"{kind} {k},{e}"] = dict(
                    kmers_per_s=[kps, kps2], mismatches=bad, batches=st["batches"],
                    collectives=ncoll, wire_bytes=nbytes, collective_ms=coll_ms,
                    collective_host_ms=host_ms, nccl_kernels=n_nccl,
                    bound_ms=bound_ms, launches=sum(counts.values()))
    finally:
        dist.destroy_process_group()
    return res


def mesh4_rank(work, refs):
    """One rank of phase 10 (four ranks on one card over gloo)."""
    import torch.distributed as dist

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.parallel.dryrun import dryrun_multichip
    from genmap_tpu_torch.parallel.mesh import data_mesh
    from genmap_tpu_torch.parallel.partmesh import part_data_mesh

    r = dist.get_rank()
    res = {"dryrun": dryrun_multichip(4, "cuda")}
    runs = []
    two = os.path.join(work, "mesh_two")
    jobs = [(f"part(2) x data(2) ({k},{e})", part_data_mesh(2, 4), two, k, e, ())
            for k, e in ((K, E), (24, 1))]
    jobs.append(("part(2) x data(2) -d selection", part_data_mesh(2, 4), two, K, E,
                 ("-d", "-S", refs["bed"])))
    jobs.append((f"data(4) on the 3-part index ({K},{E})", data_mesh(4), refs["split"],
                 K, E, ()))
    checker = _Checker(kernels)
    with checker:
        for what, mesh, idx, k, e, extra in jobs:
            out = os.path.join(work, "mesh4_" + "".join(c for c in what if c.isalnum()))
            report = {}
            t = time.perf_counter()
            c0 = mesh.collectives
            if r == 0:  # rank 0's first batch of every program against plain
                with first_batches_checked(checker, f"mesh4 {what}"):
                    counts = mesh_map(idx, out, k, e, mesh, extra, report)
            else:
                counts = mesh_map(idx, out, k, e, mesh, extra, report)
            runs.append(dict(what=what, out=out, wall=time.perf_counter() - t,
                             compute_s=report["compute_s"], n_kmers=report["n_kmers"],
                             stats={x: report["stats"][x] for x in
                                    ("batches", "probe_skipped", "tier_blocks",
                                     "max_tier")},
                             collectives=mesh.collectives - c0, launches=counts))
    res["runs"] = runs
    res["checked"] = dict(calls=checker.calls, err=checker.err,
                          variants={n: sorted(v) for n, v in checker.variants.items()})
    return res


def nccl2_rank(idx, out):
    """part(2) x data(1) over NCCL, one rank per card."""
    from genmap_tpu_torch.parallel.partmesh import part_data_mesh

    mesh_map(idx, out, K, E, part_data_mesh(2, 2))


def mesh4_phase(work, refs):
    """Phase 10: four ranks on cuda:0 over gloo (each spawned process binds
    cuda:0): dryrun_multichip(4); chrI-chrVII in two parts (-xm) on
    part(2) x data(2) at (100,2), (24,1) and the multipart phase's -d
    selection, and data(4) on its 3-part index at (100,2): every output
    file byte-equal to the single-GPU run's; rank 0's first batch of each
    program checked against the plain versions.  With two or more cards,
    part(2) x data(1) over NCCL too."""
    import torch

    from genmap_tpu_torch.cli.main import main as cli_main
    from genmap_tpu_torch.index.fmindex import FMIndexData
    from genmap_tpu_torch.parallel.dist import launch_local

    two = os.path.join(work, "mesh_two")
    if cli_main(["index", "-F", refs["fa"], "-I", two, "-xm", str(MESH_XM)]) != 0:
        raise AssertionError("genmap-tpu-torch index -xm (two parts) failed")
    parts = FMIndexData.load(two).parts
    if len(parts) != 2:
        raise AssertionError(f"-xm {MESH_XM} gave {len(parts)} parts, not 2")
    log(f"mesh4: two-part index of {[p.n_total for p in parts]} symbols")
    t = time.perf_counter()
    ranks = launch_local(4, mesh4_rank, work, refs, device="cuda",
                         backend="gloo", store_dir=work, timeout_s=900)
    log(f"mesh4: four ranks on cuda:0 over gloo done in {time.perf_counter() - t:.1f} s")
    for line in ranks[0]["dryrun"]["lines"]:
        log(f"mesh4: {line}")
    if any(r["dryrun"]["lines"] != ranks[0]["dryrun"]["lines"] for r in ranks):
        raise AssertionError("dryrun_multichip(4): ranks disagree")
    ref_trees = refs["trees"]
    res = {"dryrun": ranks[0]["dryrun"]["lines"]}
    for run in ranks[0]["runs"]:
        what = run["what"]
        got = read_tree(run["out"])
        want = (refs["sel"] if "selection" in what else
                ref_trees[(24, 1)] if "(24,1)" in what else ref_trees[(K, E)])
        same = sorted(fn for fn in want if want[fn] == got.get(fn))
        kps = run["n_kmers"] / run["compute_s"]
        log(f"mesh4: {what}: {run['compute_s']:.2f} s compute ({kps:.1f} k-mers/s, "
            f"{run['wall']:.2f} s wall on rank 0), stats {run['stats']}, "
            f"{run['collectives']} collectives; files {sorted(got)} byte-equal to the "
            f"single-GPU run's: {same}; rank 0 launches {run['launches']}")
        if sorted(got) != sorted(want) or len(same) != len(want):
            raise AssertionError(f"mesh4 {what}: output files differ from the single GPU's")
        need = ["extract_needles", "candidate_step", "compact", "count_tail", "seed_lookup"]
        need += (["locate"] if "selection" in what else
                 ["probe_mass"] if f"({K},{E})" in what else [])
        missing = [n for n in need if run["launches"][n] <= 0]
        if missing:
            raise AssertionError(f"mesh4 {what}: kernels not launched on rank 0: {missing}")
        res[what] = dict(kmers_per_s=kps, mismatched_files=len(want) - len(same),
                         collectives=run["collectives"])
    ch = ranks[0]["checked"]
    log(f"mesh4: rank 0 kernel calls equal to plain {ch['calls']} (variants of "
        f"probe_mass: {ch['variants']['probe_mass']})")
    if any(ch["err"].values()) or not any("reduced" in v for v in
                                          ch["variants"]["probe_mass"]):
        raise AssertionError("mesh4: no reduced probe_mass call was checked")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out = os.path.join(work, "mesh_nccl2")
        launch_local(2, nccl2_rank, two, out, device="cuda", backend="nccl",
                     store_dir=work, timeout_s=600)
        tree = read_tree(out)
        ok = tree.get("mp.genmap.freq16") == ref_trees[(K, E)]["mp.genmap.freq16"]
        log(f"mesh: part(2) x data(1) over NCCL on {n_cards} cards: frequencies "
            f"byte-equal {ok}")
        if not ok:
            raise AssertionError("part(2) x data(1) over NCCL differs")
        res["nccl2"] = True
    else:
        log("mesh: part(2) x data(1) over NCCL not run: this machine has "
            f"{n_cards} CUDA device(s)")
        res["nccl2"] = False
    return res


# ---------------------------------------------------------------------------
# phase 11: the row gather (the Pallas harness's port) and the read rates
# ---------------------------------------------------------------------------


def rowgather_edges(dev) -> int:
    """row_gather_sum and row_gather_chain against their plain versions on
    the card, every lanes variant (0: the bulk copies): the harness's table
    shape (16 B vector reads, bulk copies) and a 69-word one (word reads;
    the bulk entries refuse it and lanes 0 takes the word kernel), each also with row sums that all
    wrap negative; 4,096 ids (whole chunks), 4,000 (the last 32 dropped)
    and 4,007 at chunk 1 (a partial last stage of the bulk sum); a grid
    capped at 132 blocks (grid stride); a table that is not 16 B aligned.
    Returns the largest error (0), or raises."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.experiments import row_gather as rg

    NR = rg.HARNESS["NR"]
    cases = 0
    for W in (128, 69):
        rng = np.random.default_rng(SEED + W)
        for table in (rg.harness_inputs(NR, W, 0, 0)[0],
                      rg.negative_wrap_table(NR, W, seed=SEED + W)):
            t = torch.from_numpy(table).to(dev)
            shifted = torch.cat([t.new_zeros(1), t.flatten()])[1:].view(NR, W)
            tables = (t, shifted)
            for ND, chunk in ((4096, 128), (4000, 128), (4007, 1)):
                idx = torch.from_numpy(rng.integers(0, NR, ND).astype(np.int32)).to(dev)
                want = int(kernels.row_gather_sum_plain(t, idx, chunk))
                for tt in tables:
                    for lanes in rg.LANES:
                        for blocks in (0, 132):
                            got = int(kernels.row_gather_sum(tt, idx, chunk, lanes=lanes,
                                                             blocks=blocks))
                            if got != want:
                                raise AssertionError(
                                    f"row_gather_sum W={W} ND={ND} chunk={chunk} "
                                    f"lanes={lanes} blocks={blocks}: {got} != plain {want}")
                            cases += 1
            idx = torch.from_numpy(rng.integers(0, NR, 1 << 17).astype(np.int32)).to(dev)
            want = int(kernels.row_gather_chain_plain(t, idx))
            for tt in tables:
                for lanes in rg.LANES:
                    for blocks in (0, 132):
                        got = int(kernels.row_gather_chain(tt, idx, lanes=lanes,
                                                           blocks=blocks))
                        if got != want:
                            raise AssertionError(
                                f"row_gather_chain W={W} lanes={lanes} blocks={blocks}: "
                                f"{got} != plain {want}")
                        cases += 1
    log(f"rowgather: {cases} edge-case calls equal to plain (lanes {rg.LANES}, 0 the "
        f"bulk copies; W 128 and 69, row sums wrapping negative, ND 4,096 and 4,000 "
        f"at chunk 128 and 4,007 at chunk 1, grids auto and 132 blocks, a table off "
        f"16 B alignment)")
    return 0


def dense_candidate_step(dev, checker, idx):
    """candidate_step's largest checked call with every state valid and
    random intervals on the main genome's index (its mono rows L2-sized):
    the kernel's read rate when each thread reads rows.  Held against the
    plain version; returns (ms, row reads, shape)."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.index.fmindex import FMIndexData
    from genmap_tpu_torch.ops import rank

    data = FMIndexData.load(idx)
    index = rank.DeviceIndex.from_part(data, data.parts[0], light=True, device=dev)
    _size, args, _phase = checker.largest["candidate_step"]
    if args["index"].nchars != index.nchars:
        raise AssertionError("candidate_step's largest call is on another alphabet")
    st = args["st"].clone()
    R, N = st.shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = int(index.n_total)
    for r, (lo, hi) in enumerate(((0, n - 64), (0, n - 64), (1, 64))):  # flo, rlo, size
        st[r] = torch.randint(lo, hi, (N,), device=dev, generator=gen, dtype=torch.int32)
    dense = dict(args, index=index, st=st, valid=torch.ones(N, dtype=torch.uint8, device=dev))
    got = checker.orig["candidate_step"](**dense)
    err = max_abs_err(kernels.candidate_step_view(got, **dense),
                      kernels.candidate_step_view(kernels.candidate_step_plain(**dense),
                                                  **dense))
    if err:
        raise AssertionError(f"dense candidate_step differs from plain (max abs err {err})")
    ms = device_ms(lambda: checker.orig["candidate_step"](**dense))
    _b, _o, shape, n_reads = kernel_work("candidate_step", dense)
    return ms, n_reads, shape


def rowgather_phase(dev, checker, idx):
    """Phase 11: the row-gather entry point (`experiments/row_gather.py`,
    the port of the Pallas harness) at the harness's sizes and its sweep,
    launch counters set to 0 just before and read just after (row_gather
    must launch); the edge cases against the plain versions; then the read
    rates of candidate_step and dimer_step (their largest checked calls,
    and candidate_step with every state valid) beside the sweep's random
    read rates at their row widths.  Returns the kernels line's row and a
    summary."""
    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.experiments import row_gather as rg

    kernels.reset_launches()
    res = rg.run(dev, say=log)
    counts = kernels.launch_counts()
    if counts["row_gather"] <= 0:
        raise AssertionError("row_gather was not launched by the row-gather entry point")
    log(f"rowgather: row_gather launches in the entry point's run {counts['row_gather']}")
    err = rowgather_edges(dev)

    def rate(table, rb, lanes):
        for r in res["sweep"]:
            if (r["table"], r["row_bytes"], r["kind"], r["pattern"], r["lanes"],
                    r["blocks"]) == (table, rb, "sum", "random", lanes, "auto"):
                return r["rows_per_s"]
        raise AssertionError(f"no sweep row for {table} {rb} B lanes {lanes}")

    def ceiling(rb):
        return ", ".join(f"lanes {ln}: {rate('20 MB', rb, ln):.3e} (20 MB, L2) / "
                         f"{rate('4 GiB', rb, ln):.3e} (4 GiB, HBM)"
                         for ln in rg.SWEEP_LANES + (0,))

    summary = {}
    for name, rb in (("candidate_step", 208), ("dimer_step", 512)):
        _size, args, phase = checker.largest[name]
        ms = device_ms(lambda: checker.orig[name](**args))
        _b, _o, shape, n_reads = kernel_work(name, args)
        summary[f"{name}_rows_per_s"] = n_reads / (ms * 1e-3)
        log(f"rowgather: {name}, largest checked call (in {phase}: {shape}): "
            f"{n_reads / (ms * 1e-3):.3e} rows/s in {ms:.4f} ms; random {rb} B row "
            f"reads in the sweep, rows/s: {ceiling(rb)}")
    ms, n_reads, shape = dense_candidate_step(dev, checker, idx)
    summary["candidate_step_dense_rows_per_s"] = n_reads / (ms * 1e-3)
    log(f"rowgather: candidate_step with every state valid on the main index "
        f"({shape}): {n_reads / (ms * 1e-3):.3e} rows/s in {ms:.4f} ms; random 208 B "
        f"row reads in the sweep, rows/s: {ceiling(208)}")
    # locate's yardstick: dependent reads of its sub-row widths from the
    # table about the size of the main index's rank rows
    summary["chain_rows_per_s"] = {
        rb: {ln: next(r["rows_per_s"] for r in res["sweep"]
                      if (r["table"], r["row_bytes"], r["kind"], r["lanes"])
                      == ("20 MB", rb, "chain", ln))
             for ln in rg.SWEEP_LANES}
        for rb in (208, 276)}
    for rb in rg.BULK_ROW_BYTES:
        summary[f"sweep_{rb}B_rows_per_s"] = {
            f"{t} lanes {ln}": rate(t, rb, ln) for t in rg.BULK_TABLES
            for ln in rg.SWEEP_LANES + (0,)}
        summary[f"sweep_{rb}B_chain_rows_per_s"] = {
            f"{t} lanes {ln}": next(r["rows_per_s"] for r in res["sweep"]
                                    if (r["table"], r["row_bytes"], r["kind"], r["lanes"])
                                    == (t, rb, "chain", ln))
            for t in rg.BULK_TABLES for ln in rg.SWEEP_LANES + (0,)}
    h = res["harness"]["sum"]
    row = dict(name="row_gather", route="cuda", source="genmap_tpu_torch/csrc/row_gather.cu",
               replaces=kernels.ROW_GATHER.replaces, launches=counts["row_gather"],
               max_abs_err=err, ms=h["lanes"][h["default_lanes"]], plain_ms=h["plain_ms"],
               bound_ms=h["bound_ms"], bound_by="bytes", library_ms=h["library_ms"])
    summary["harness_ms"] = {k: v["lanes"][v["default_lanes"]]
                             for k, v in res["harness"].items()}
    return row, summary


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

    summary = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return res

    with _Checker(kernels) as checker:
        phase("dna5", dna5_phase, dev, checker)
        with tempfile.TemporaryDirectory(prefix="genmap_smoke_") as work:
            launches, summary["main"], idx, chroms, gpu_freq, ref = phase(
                "main", main_path, dev, work, checker)
            summary["mesh1"] = phase("mesh1", mesh1_phase, work, idx, ref, checker)
            summary["check"] = phase("check", check_phase, work, idx, chroms,
                                     gpu_freq, checker)
            csv_counts, summary["csv"] = phase("csv", csv_phase, work, idx, chroms,
                                               gpu_freq)
            summary["dedup"] = phase("dedup", dedup_phase, dev, checker)
            summary["ep"] = phase("ep", ep_phase, work)
            summary["multipart"], refs = phase("multipart", multipart_phase, work,
                                               checker)
            summary["mesh4"] = phase("mesh4", mesh4_phase, work, refs)
            rg_row, summary["rowgather"] = phase("rowgather", rowgather_phase, dev,
                                                 checker, idx)
            # launches: the whole-genome map's, and locate's from the -d map of chrI
            launches = dict(launches, locate=csv_counts["locate"])
            rows = phase("kernels", time_kernels, checker, launches,
                         summary["rowgather"]["chain_rows_per_s"]) + [rg_row]
            phase("seed tables", time_seed_tables, idx)
    log(f"summary: {json.dumps(summary)}")
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
