#!/usr/bin/env python3
"""A/B timing of whole-genome maps on one GPU.

    python3 chip_ab.py OTHER_CHECKOUT [--runs N] [--busy]
    python3 chip_ab.py --dimer [--runs N] [--busy]
    python3 chip_ab.py OTHER_CHECKOUT --kernels [--only KERNEL,...]

Builds chip_smoke.py's 12.07 Mbp genome-like genome and its index once,
then maps it with `genmap-tpu-torch map -K k -E e -fl -r` on the card from
separate processes.  With OTHER_CHECKOUT, at (100,2) in the order A, B, C,
C, B, A, then at (24,1) in the order A, B, B, A:

  A  the genmap_tpu_torch of OTHER_CHECKOUT (e.g. the parent commit,
     unpacked with `git archive`)
  B  this checkout's
  C  this checkout's with the unique-infix probe turned off

With --dimer, this checkout's engine with its dimer-tier policy as by
default (A: dimer_tier=None, tier 0 on the dimer rows where the pool
schedule is wide, twins before the wide exact tiers) against
dimer_tier=False (B: mono rows only), in the order A, B, B, A, at (100,2)
and then at (24,1).

With --kernels, no map: `candidate_step`, `dimer_step`, `extract_needles`,
`compact`, `count_tail`, `gather_states`, `locate`, `seed_lookup`,
`probe_mass`, the seed-table build (each checkout's
`rank.with_seed_tables`, on the three indexes below at their own depths:
its launches, peak allocated bytes, host issue time, each launch's device
ms and PyTorch's own device ops under the profiler, and the upload's wall
time) and `row_gather` (every lanes value of each checkout, and its
default) of OTHER_CHECKOUT (A) and of this checkout (B) are timed in
turns, A B B A, one process each, on the same seeded inputs (made on the
card from a torch.Generator seed; candidate_step reads a random rank table
of the main index's size, dimer_step a random dimer table of its size;
locate walks real indexes, built once by this process with
`genmap-tpu-torch index` from chip_smoke.py's genome-like genomes: the
12.07 Mbp main genome, the 1 Mbp Dna5 genome of its dna5 phase and a
LARGE_BP genome-like genome, on rows drawn with a numpy seed, in runs of
consecutive SA rows as `-d` draws them or scattered; seed_lookup reads the
main index's own seed tables, built by each process, with needle windows
extracted from its text at seeded starts) at the shapes of KERNEL_CASES
(--only: those kernels' cases, variants and sweep only, and only the
indexes they read), with chip_smoke.py's
`device_ms` (CUDA events, L2 flushed, median of 10; and with L2 warm,
queued behind a spin); every process's outputs must hash the same
(candidate_step's and dimer_step's as their output contracts define them:
this checkout's `kernels.candidate_step_view` / `dimer_step_view`);
gather_states is timed beside `index_select` of the same rows and
probe_mass beside `scatter_add` of the same masses (chip_smoke.py's
`library_fn`) in the same process.  This checkout's processes also time
`candidate_step`, `dimer_step`, `extract_needles`, `locate`,
`gather_states`, `seed_lookup`, `probe_mass`, `seed_build` and
`row_gather` (its bulk copies) at each of their cases in
VARIANTS (their sources built with CS_LANES / CS_COOP_MAX, DS_LANES /
DS_COOP_MAX / DS_WAVES, EN_THREADS / EN_WIDE_BYTES, LC_LANES / LC_THREADS
/ LC_WAVES / LC_MIN_BLOCKS, GS_THREADS, SL_THREADS, PM_THREADS /
PM_CAP / PM_SPEC_F / PM_MIN_BLOCKS, SB_SHALLOW / SB_THREADS and RB_STAGES
overridden, the measurement behind
those defaults; outputs must equal the kernel's; each variant's ptxas
registers printed), two memsets of the two step
kernels' valid2 and far as a floor for the bytes every state costs, and
`compact` at COMPACT_SWEEP's shapes with its middle-row and its long-row
regime forced (behind `kernels.COMPACT_LONG_M`).

Each process builds its kernels, maps once to warm up, then maps N times
(default 3); it reports the compute time of each run (`map`'s own
compute_s: index upload and seed tables excluded), the engine's dispatch /
fetch seconds, batches, blocks per tier, kernel launches, peak allocated
device bytes and its frequencies' checksum, which must agree across all
processes of one configuration.  With --busy, one more map under
torch.profiler (device activity only, as chip_smoke.py's
`profiled_device_times`) gives each kernel's device ms over a whole map
(and that of PyTorch's own device ops, `other`), its calls with their
median and 90th-percentile device ms, and the device-busy share
(device time over the map's wall time, the profiler's overhead
included).  Printed last: one JSON object with every process's numbers
and the card's name and power limit.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import hashlib, json, os, sys
root, idx, out, runs, probe = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5] == "1"
dimer, k, e, busy, here = sys.argv[6], sys.argv[7], sys.argv[8], sys.argv[9] == "1", sys.argv[10]
sys.path.insert(0, root)
import numpy as np, torch
torch.set_num_threads(min(8, os.cpu_count() or 1))
from genmap_tpu_torch import kernels
from genmap_tpu_torch.cli.map_cmd import map_main
from genmap_tpu_torch.engine.mappability import MappabilityEngine
init = MappabilityEngine.__init__
def configured(self, *a, **kw):
    init(self, *a, **kw)
    self._probe_enabled = probe
    if dimer == "off":
        self._dimer_mode = False
MappabilityEngine.__init__ = configured
kernels.build()
res = []
argv = ["-I", idx, "-K", k, "-E", e, "-fl", "-r", "--device", "cuda"]
for i in range(runs + 1):
    o = os.path.join(out, str(i))
    os.makedirs(o)
    report = {}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    if map_main(argv + ["-O", o + "/"], report=report) != 0:
        sys.exit(1)
    torch.cuda.synchronize()
    with open(os.path.join(o, "yeastlike.genmap.freq16"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    st = report["stats"]
    if i:
        res.append(dict(compute_s=report["compute_s"], n_kmers=report["n_kmers"],
                        dispatch_s=st["dispatch_s"], fetch_s=st["fetch_s"],
                        batches=st["batches"], sha=digest,
                        dimer_tier=st.get("dimer_tier"),
                        tier_blocks={str(t): n for t, n in st["tier_blocks"].items()},
                        probe_skipped=st["probe_skipped"],
                        launches=sum(kernels.launch_counts().values()),
                        peak_bytes=torch.cuda.max_memory_allocated()))
share, per_map, per_call = None, None, None
if busy:
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    o = os.path.join(out, "profiled")
    os.makedirs(o)
    wall, calls, _grids, other_ms, _n = cs.profiled_device_times(
        lambda: map_main(argv + ["-O", o + "/"], report={}))
    per_map = {n: sum(c) for n, c in calls.items()}
    per_map["other"] = other_ms
    per_call = {n: [len(c), float(np.median(c)), float(np.percentile(c, 90))]
                for n, c in calls.items() if c}
    dev_ms = sum(per_map.values())
    share = dev_ms / 1e3 / wall if dev_ms > 0 else None
for r in res:
    r["busy_share"], r["device_ms_per_map"], r["calls_median_p90_ms"] = share, per_map, per_call
print(json.dumps(res))
"""


# (label, kernel, shape): candidate_step A, R, B, per_block, inner, G,
# exact, mean valid share of a frontier row (its valid states first; 1.0:
# every state valid, intervals under 64 symbols), share of active groups;
# dimer_step A, R, B, per_block, inner, G, exact, mean valid share,
# with_mono, with_pass (groups g % 4 == 1 consume 1 with mono steps, g % 4
# == 3 pass through with passthrough slots, the rest consume 2);
# extract_needles B, Ln, N mask; compact R, rows, M, F, count, max row
# density; count_tail B, J, Fe, with_exact, mean valid share; seed_lookup
# B, P, Fp, t_seed, Ln, share of N bytes; probe_mass B, F, P, Ln, Dna5,
# entry ("one": the map's launch; "acc": a part's running sum out; "last":
# the last part's decision with masses; "reduced"), mean valid share.
# The shapes of the smoke's largest call of each timed variant or regime
# (a mean density of 1.5 % is that of its largest compact call), and a few
# more
KERNEL_CASES = (
    ("candidate_step largest, R=5 exact", "candidate_step",
     (4, 5, 768, 4096, 4096, 2, True, 0.00243, 1.0)),
    ("candidate_step R=5 fast", "candidate_step",
     (4, 5, 2048, 512, 512, 2, False, 0.01669, 1.0)),
    ("candidate_step R=4 fast, passthrough", "candidate_step",
     (4, 4, 1024, 784, 16, 49, False, 0.0878, 0.69)),
    ("candidate_step R=4 exact, passthrough", "candidate_step",
     (4, 4, 837, 3136, 64, 49, True, 0.01565, 0.69)),
    ("candidate_step R=4 fast, passthrough, B=128", "candidate_step",
     (4, 4, 128, 784, 16, 49, False, 0.0878, 0.69)),
    ("candidate_step R=5 exact, B=1024, F=64", "candidate_step",
     (4, 5, 1024, 64, 64, 3, True, 0.3, 1.0)),
    ("candidate_step no valid state, R=5", "candidate_step",
     (4, 5, 768, 4096, 4096, 2, True, 0.0, 1.0)),
    ("candidate_step dense (every state valid)", "candidate_step",
     (4, 5, 768, 4096, 4096, 2, True, 1.0, 1.0)),
    ("dimer_step R=5 exact, 2 % valid (largest)", "dimer_step",
     (4, 5, 768, 4096, 4096, 3, True, 0.0214, False, False)),
    ("dimer_step R=4 fast, passthrough", "dimer_step",
     (4, 4, 1024, 784, 16, 49, False, 0.0878, False, True)),
    ("dimer_step R=4 fast, mono steps, passthrough", "dimer_step",
     (4, 4, 1024, 784, 16, 49, False, 0.0878, True, True)),
    ("dimer_step R=5 fast, B=1024, F=64, 30 % valid", "dimer_step",
     (4, 5, 1024, 64, 64, 3, False, 0.3, False, False)),
    ("dimer_step no valid state, R=5", "dimer_step",
     (4, 5, 768, 4096, 4096, 3, True, 0.0, False, False)),
    ("dimer_step dense (every state valid)", "dimer_step",
     (4, 5, 768, 4096, 4096, 3, True, 1.0, False, False)),
    ("dimer_step small, R=4 fast, passthrough, rows half valid, B=16", "dimer_step",
     (4, 4, 16, 784, 16, 49, False, 0.5, False, True)),
    ("dimer_step small, R=5 fast, B=128, F=64, 30 % valid", "dimer_step",
     (4, 5, 128, 64, 64, 3, False, 0.3, False, False)),
    ("dimer_step small, R=4 exact, passthrough, B=64", "dimer_step",
     (4, 4, 64, 784, 16, 49, True, 0.0878, False, True)),
    ("extract_needles largest, Ln=29", "extract_needles", (8334, 29, False)),
    ("extract_needles Ln=148", "extract_needles", (8192, 148, False)),
    ("extract_needles Ln=148, B=1024", "extract_needles", (1024, 148, False)),
    ("extract_needles Ln=148, B=256", "extract_needles", (256, 148, False)),
    ("extract_needles Ln=29, B=512", "extract_needles", (512, 29, False)),
    ("extract_needles Ln=148, B=1024, N mask", "extract_needles", (1024, 148, True)),
    ("compact largest, M=1024 (middle)", "compact", (4, 49152, 1024, 64, False, 0.03)),
    ("compact count, M=8192 (long)", "compact", (5, 2048, 8192, 512, True, 0.2)),
    ("compact M=8192 (long)", "compact", (4, 6144, 8192, 512, False, 0.03)),
    ("compact M=262144 (long)", "compact", (5, 4, 262144, 16384, True, 0.2)),
    ("compact M=16 (short)", "compact", (4, 100352, 16, 4, False, 0.6)),
    ("compact M=16, 8192 rows (short)", "compact", (5, 8192, 16, 4, False, 1.0)),
    ("count_tail largest, Fe=64", "count_tail", (8192, 6, 64, False, 0.24)),
    ("count_tail Fe=1", "count_tail", (2048, 49, 1, False, 0.8)),
    ("count_tail Fe=1, B=8192", "count_tail", (8192, 50, 1, False, 0.8)),
    ("count_tail exact, Fe=64", "count_tail", (1003, 49, 64, True, 0.12)),
    ("gather_states largest, B=1024 npad=32 n=26 Fc=256 Fe=128", "gather_states",
     (1024, 32, 26, 256, 128)),
    ("gather_states Fc=64 Fe=16, B=2048 npad=1024", "gather_states", (2048, 1024, 1000, 64, 16)),
    ("gather_states Fc=32 Fe=64, B=2048 npad=1024", "gather_states", (2048, 1024, 1000, 32, 64)),
    ("gather_states Fc=4 Fe=8, B=8192 npad=8192", "gather_states", (8192, 8192, 8000, 4, 8)),
    ("locate smoke's largest, 521,207 clustered rows", "locate", ("main", 521_207, True)),
    ("locate engine chunk, 1,048,576 clustered rows", "locate", ("main", 1 << 20, True)),
    ("locate engine chunk, 1,048,576 scattered rows", "locate", ("main", 1 << 20, False)),
    ("locate small, 25,000 clustered rows", "locate", ("main", 25_000, True)),
    ("locate Dna5, 262,144 clustered rows", "locate", ("dna5", 1 << 18, True)),
    ("locate large index, 1,048,576 scattered rows", "locate", ("large", 1 << 20, False)),
    ("seed_lookup largest, (100,2): B=8192 P=3 Fp=4 t_seed=12 Ln=148", "seed_lookup",
     (8192, 3, 4, 12, 148, 0.0)),
    ("seed_lookup (100,2), B=1024", "seed_lookup", (1024, 3, 4, 12, 148, 0.0)),
    ("seed_lookup (24,1): B=8192 P=2 Fp=16 t_seed=9 Ln=29", "seed_lookup",
     (8192, 2, 16, 9, 29, 0.0)),
    ("seed_lookup (24,1), B=1024", "seed_lookup", (1024, 2, 16, 9, 29, 0.0)),
    ("seed_lookup (100,4): B=8192 P=7 Fp=8 t_seed=12 Ln=124", "seed_lookup",
     (8192, 7, 8, 12, 124, 0.0)),
    ("seed_lookup Dna5 needles (1 % N), (100,2), B=1024", "seed_lookup",
     (1024, 3, 4, 12, 148, 0.01)),
    ("seed_lookup t_seed=0, B=8192 P=3 Fp=4", "seed_lookup",
     (8192, 3, 4, 0, 148, 0.0)),
    ("probe_mass wide pool, B=8192 F=64 P=3", "probe_mass", (8192, 64, 3, 148, False, "one", 0.1)),
    ("probe_mass F=4, B=8192 P=3", "probe_mass", (8192, 4, 3, 148, False, "one", 0.5)),
    ("probe_mass F=12, B=8192 P=3", "probe_mass", (8192, 12, 3, 148, False, "one", 0.3)),
    ("probe_mass F=8 P=7 (e=4), B=8192", "probe_mass", (8192, 8, 7, 124, False, "one", 0.3)),
    ("probe_mass F=64, B=1024", "probe_mass", (1024, 64, 3, 148, False, "one", 0.1)),
    ("probe_mass Dna5 N windows, F=64 B=1024", "probe_mass", (1024, 64, 3, 148, True, "one", 0.1)),
    ("probe_mass multi-part, acc in and out (last=False), F=64", "probe_mass",
     (8192, 64, 3, 148, False, "acc", 0.1)),
    ("probe_mass multi-part, last part with masses, F=64", "probe_mass",
     (8192, 64, 3, 148, False, "last", 0.1)),
    ("probe_mass reduced entry, B=8192 P=3", "probe_mass", (8192, 0, 3, 0, False, "reduced", 0.0)),
    # the (100,2) map's own launch, the smoke's largest checked call (888
    # valid of 8,192 x 6 slots; a share of 0.0467 draws ~878, one a block)
    ("probe_mass largest, the map's: B=8192 F=6 P=3, ~878 valid", "probe_mass",
     (8192, 6, 3, 148, False, "one", 0.0467)),
    # the seed-table build (`rank.with_seed_tables` of each checkout) of a
    # whole index part at its own depth: the main index (t0 12), the Dna5
    # index (t0 11) and the 64 Mbp one (t0 12, rank rows twice L2)
    ("seed_build main index (12.07 Mbp), t0 = its depth", "seed_build", ("main",)),
    ("seed_build Dna5 index (1 Mbp), t0 = its depth", "seed_build", ("dna5",)),
    ("seed_build 64 Mbp index, t0 = its depth", "seed_build", ("large",)),
    # row_gather: entry, row bytes, table bytes, ids (chains), chunk; every
    # lanes value of each checkout timed, the default beside A's
    ("row_gather the harness's sum: ND 4,096, CHUNK 128, 512 B rows, 16 MB", "row_gather",
     ("sum", 512, 31_250 * 512, 4096, 128)),
    *((f"row_gather {kind} {rb} B rows, {label} table", "row_gather",
       (kind, rb, nbytes, (1 << 20) if kind == "sum" else (1 << 17), 1))
      for kind in ("sum", "chain") for label, nbytes in (("20 MB", 20_000_000),
                                                        ("4 GiB", 4 << 30))
      for rb in (208, 416, 512)),
)
# locate's indexes (kernel_inputs "locate" shape[0]); LARGE_BP: the
# flagship corpus size, whose index (paired rank rows ~104 MB, twice L2)
# the call builds in about a minute of the card host's time
LARGE_BP = 64_000_000
CLUSTER_MEAN = 2.26  # rows per k-mer of the smoke's -d map of chrI (521,207 / 230,218)
# Variants of this checkout's kernels timed at each of their cases: the
# kernel's source built with its macros overridden (nvcc -D) into a library
# of its own.  candidate_step: CS_LANES, lanes per cooperatively read state
# (0, the default: 32 / the warp's working states), and CS_COOP_MAX, the
# most working states a warp reads cooperatively (8; 0: always a lane per
# state); dimer_step: DS_LANES, lanes per working state (4; 1: a lane per
# state), DS_COOP_MAX, the most working states a warp reads with DS_LANES
# lanes each, more a lane each (32: never), DS_WAVES, the least waves of
# resident blocks (4), and DS_MIN_BLOCKS, the resident blocks per SM asked
# of the compiler (6: at most 80 registers; 8: 64; 1: uncapped);
# extract_needles: EN_THREADS (256) and EN_WIDE_BYTES, the output size
# from which a thread writes 16 bytes, smaller outputs a byte (512 KiB; 0:
# always, where rows allow; 2^30: never)
# locate: LC_LANES, lanes per walked row (1), LC_THREADS (128),
# LC_WAVES, the grid capped at that many waves of resident blocks whose
# groups take rows in a grid-stride loop (0: a row per group), and
# LC_MIN_BLOCKS, resident blocks per SM asked of the compiler (0: none);
# gather_states: GS_THREADS (256; rows per block = GS_THREADS / the row's
# lanes); seed_lookup: SL_THREADS (256); probe_mass: PM_THREADS (256),
# PM_CAP, the lane mass at which the decision-only combine saturates (7;
# 1: thresholds of 1 take the exact 64-bit combine), and PM_SPEC_F, the
# most slots a block may have for its plan and size words to be loaded
# beside the validity (16; 0: never), and PM_MIN_BLOCKS, resident blocks
# per SM asked of the compiler for P <= 8 (2048 / PM_THREADS; 1: none)
VARIANTS = {
    "locate": ({"LC_LANES": 2}, {"LC_LANES": 4}, {"LC_WAVES": 1}, {"LC_WAVES": 4},
               {"LC_MIN_BLOCKS": 12}, {"LC_MIN_BLOCKS": 16}, {"LC_THREADS": 64},
               {"LC_THREADS": 256}, {"LC_THREADS": 256, "LC_MIN_BLOCKS": 6}),
    "gather_states": ({"GS_THREADS": 64}, {"GS_THREADS": 128}, {"GS_THREADS": 512}),
    "seed_lookup": ({"SL_THREADS": 128}, {"SL_THREADS": 512}),
    "probe_mass": ({"PM_CAP": 1}, {"PM_SPEC_F": 0}, {"PM_SPEC_F": 32}, {"PM_MIN_BLOCKS": 1},
                   {"PM_THREADS": 128}, {"PM_THREADS": 512}),
    "candidate_step": ({"CS_COOP_MAX": 4}, {"CS_COOP_MAX": 16}, {"CS_COOP_MAX": 32},
                       {"CS_LANES": 8, "CS_COOP_MAX": 4}, {"CS_LANES": 4},
                       {"CS_LANES": 16, "CS_COOP_MAX": 2}, {"CS_COOP_MAX": 0}),
    "dimer_step": ({"DS_MIN_BLOCKS": 1}, {"DS_MIN_BLOCKS": 8}, {"DS_LANES": 1},
                   {"DS_LANES": 2}, {"DS_LANES": 8}, {"DS_LANES": 16}, {"DS_WAVES": 2}),
    "extract_needles": ({"EN_WIDE_BYTES": 0}, {"EN_WIDE_BYTES": 1 << 30},
                        {"EN_THREADS": 128}),
    "seed_build": ({"SB_SHALLOW": 6}, {"SB_SHALLOW": 10}, {"SB_THREADS": 256},
                   {"SB_SHALLOW": 6, "SB_THREADS": 256}),
    "row_gather": ({"RB_STAGES": 1}, {"RB_STAGES": 3}, {"RB_STAGES": 4}),
}
# compact shapes timed with each of the two wide-row regimes forced: rows
# of the map's widths, 16 MB of validity per call or 64 rows, at a mean
# density of 1.5 % (the smoke's largest call) and of 10 %
COMPACT_SWEEP = tuple((4, rows, M, F, False, dmax)
                      for M, F in ((1024, 64), (2048, 512), (4096, 1024), (8192, 512),
                                   (16384, 4096), (65536, 4096))
                      for rows in ((16 << 20) // M, 64)
                      for dmax in (0.03, 0.2))
N_TOTAL = 24_142_684  # the main genome's index (both strands)

KCHILD = r"""
import importlib.util, json, os, sys
root, here, sweep, indexes, only = (sys.argv[1], sys.argv[2], sys.argv[3] == "1",
                                    json.loads(sys.argv[4]), json.loads(sys.argv[5]))
sys.path.insert(0, root)
from genmap_tpu_torch import kernels
if not os.path.abspath(kernels.__file__).startswith(os.path.abspath(root) + os.sep):
    sys.exit(f"genmap_tpu_torch imported from {kernels.__file__}, not {root}")
spec = importlib.util.spec_from_file_location("chip_ab_here", os.path.join(here, "chip_ab.py"))
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
print(json.dumps(ab.time_kernel_cases(kernels, here, sweep, indexes, only)))
"""


_LOADED = {}


def locate_index(path, dev):
    """The index at `path` on the card with its SA samples (light=False),
    loaded once per process with the imported package."""
    if path not in _LOADED:
        from genmap_tpu_torch.index.fmindex import FMIndexData
        from genmap_tpu_torch.ops import rank

        data = FMIndexData.load(path)
        _LOADED[path] = rank.DeviceIndex.from_part(data, data.parts[0], light=False,
                                                   device=dev)
    return _LOADED[path]


def seed_text(path, dev):
    """The text of the index at `path` on the card and its length, loaded
    once per process with the imported package."""
    key = ("text", path)
    if key not in _LOADED:
        from genmap_tpu_torch.index.fmindex import FMIndexData
        from genmap_tpu_torch.ops import rank

        data = FMIndexData.load(path)
        _LOADED[key] = (rank.DeviceText.from_host(data, dev), data.text_len)
    return _LOADED[key]


def locate_rows(n_total, N, clustered, seed):
    """N SA rows of an index of n_total rows (numpy seed): runs of
    consecutive rows of geometric length (mean CLUSTER_MEAN) at uniform
    starts, or uniform rows."""
    rng = np.random.default_rng(seed)
    if not clustered:
        return rng.integers(0, n_total, N, dtype=np.int64)
    runs = rng.geometric(1 / CLUSTER_MEAN, N)
    starts = rng.integers(0, n_total - int(runs.max()), N)
    rows = np.repeat(starts, runs) + (np.arange(int(runs.sum()))
                                      - np.repeat(np.cumsum(runs) - runs, runs))
    return rows[:N]


def kernel_inputs(kind, shape, dev, seed, indexes=None):
    """Seeded inputs of one KERNEL_CASES / COMPACT_SWEEP case, made on the
    card (the same in every process of one torch build); locate's index
    paths in `indexes`."""
    import types

    import torch

    if kind == "locate":
        key, N, clustered = shape
        index = locate_index(indexes[key], dev)
        rows = locate_rows(index.n_total, N, clustered, seed)
        pos = torch.from_numpy(rows.astype(np.uint32).view(np.int32)).to(dev)
        return dict(index=index, pos=pos, valid=torch.ones(N, dtype=torch.uint8, device=dev))
    if kind == "seed_build":
        from genmap_tpu_torch.ops import rank

        index = locate_index(indexes[shape[0]], dev)
        return dict(index=index, t0=rank.seed_depth(index.n_total))
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "row_gather":
        entry, rb, nbytes, n, chunk = shape
        NR = nbytes // rb
        table = torch.randint(0, 2**30, (NR, rb // 4), dtype=torch.int32, device=dev,
                              generator=g)
        ids = torch.randint(0, NR, (n,), dtype=torch.int32, device=dev, generator=g)
        return dict(entry=entry, table=table, idx=ids, chunk=chunk)
    if kind == "seed_lookup":
        # needle windows of the main genome at seeded starts (N bytes put
        # in at n_share), the main index's own seed tables
        from genmap_tpu_torch.ops import rank

        B, P, Fp, t, Ln, n_share = shape
        index = locate_index(indexes["main"], dev)
        text, text_len = seed_text(indexes["main"], dev)
        rng = np.random.default_rng(seed)
        starts = rng.integers(0, text_len - Ln, B).astype(np.uint32)
        needles = rank.extract_needles(text, torch.from_numpy(starts.view(np.int32)).to(dev),
                                       Ln, text_len)
        if n_share:
            needles[torch.rand((B, Ln), device=dev, generator=g) < n_share] = 4
        a_pos = torch.from_numpy(rng.integers(0, Ln - t + 1, P).astype(np.int32)).to(dev)
        return dict(index=index, needles=needles, a_pos=a_pos, t_seed=t, Fp=Fp,
                    n_total=index.n_total)

    def rand(*size):
        return torch.rand(size, device=dev, generator=g)

    def ints(lo, hi, size):
        return torch.randint(lo, hi, size, device=dev, generator=g, dtype=torch.int64)

    if kind == "candidate_step":
        A, R, B, per_block, inner, G, exact, share, act_share = shape
        N = B * per_block
        subw = 52 if A == 4 else 69
        top = 64 if share >= 1 else 600
        table = ints(-2**31, 2**31 - 1, (N_TOTAL // 512 + 2, 2 * subw)).to(torch.int32)
        index = types.SimpleNamespace(fwd_blocks=table, nchars=A, has_n=A == 5,
                                      C=ints(0, N_TOTAL, (A,)).to(torch.int32))
        st = torch.stack([ints(0, N_TOTAL - top, (N,)), ints(0, N_TOTAL - top, (N,)),
                          ints(1, top, (N,)), ints(0, 3, (N,)), ints(0, G, (N,))])[:R]
        if share >= 1:
            valid = torch.ones(N, dtype=torch.uint8, device=dev)
        else:  # each row's valid states first, as compaction leaves them
            nv = (rand(N // inner, 1) * 2 * share * inner).round()
            valid = (torch.arange(inner, device=dev)[None, :] < nv).to(torch.uint8).reshape(-1)
        act = (rand(G) < act_share).to(torch.uint8)
        act[0] = 1
        return dict(index=index, st=st.to(torch.int32).contiguous(), valid=valid,
                    per_block=per_block, inner=inner,
                    nch=ints(0, 5, (B, G)).to(torch.uint8),
                    right=ints(0, 2, (G,)).to(torch.uint8), act=act,
                    u=torch.full((G,), 2, dtype=torch.int32, device=dev),
                    lreq=torch.zeros(G, dtype=torch.int32, device=dev), exact=exact)
    if kind == "dimer_step":
        A, R, B, per_block, inner, G, exact, share, with_mono, with_pass = shape
        N = B * per_block
        top = 64 if share >= 1 else 600
        # paired sub-rows whose L_15 counts and 15th delta bytes are those
        # of rows all of valid codes (so L_15(slice) = size and exact steps
        # are not all `far`), flagged (bit 31 of word 60) on ~0.1 % of them
        nb = N_TOTAL // 128 + 1
        table = ints(0, 2**32, (nb, 128))
        for h in (0, 64):
            q = torch.arange(nb, device=dev, dtype=torch.int64) + h // 64
            table[:, h + 31] = 128 * q
            for d in range(1, 8):
                w = h + 32 + 4 * (d - 1) + 3
                table[:, w] = (table[:, w] & 0xFFFFFF) | (16 * d) << 24
            table[:, h + 60] &= 0x7FFFFFFF
            table[:, h + 60] |= (rand(nb) < 0.001).to(torch.int64) << 31
        index = types.SimpleNamespace(
            dimer_blocks=(table - (table >> 31 << 32)).to(torch.int32), nchars=A,
            has_n=A == 5, has_dimer=True, C=ints(0, N_TOTAL, (A,)).to(torch.int32),
            C2=ints(0, N_TOTAL, (16,)).to(torch.int32))
        st = torch.stack([ints(0, N_TOTAL - top, (N,)), ints(0, N_TOTAL - top, (N,)),
                          ints(1, top, (N,)), ints(0, 3, (N,)), ints(0, G, (N,))])[:R]
        if share >= 1:
            valid = torch.ones(N, dtype=torch.uint8, device=dev)
        else:  # each row's valid states first, as compaction leaves them
            nv = (rand(N // inner, 1) * 2 * share * inner).round()
            valid = (torch.arange(inner, device=dev)[None, :] < nv).to(torch.uint8).reshape(-1)
        grp = torch.arange(G, device=dev)
        consume = torch.where(with_pass & (grp % 4 == 3), 0,
                              torch.where(with_mono & (grp % 4 == 1), 1, 2)).to(torch.uint8)
        bound = torch.full((G,), 2, dtype=torch.int32, device=dev)
        zero = torch.zeros(G, dtype=torch.int32, device=dev)
        return dict(index=index, st=st.to(torch.int32).contiguous(), valid=valid,
                    per_block=per_block, inner=inner, consume=consume,
                    right=ints(0, 2, (G,)).to(torch.uint8), u_mid=bound, u_end=bound,
                    l_mid=zero, l_end=zero, nchA=ints(0, 5, (B, G)).to(torch.uint8),
                    nchB=ints(0, 5, (B, G)).to(torch.uint8), exact=exact,
                    with_mono=with_mono, with_pass=with_pass)
    if kind == "probe_mass":
        # survivors as the probe's compaction leaves them (each row's valid
        # slots first), sizes of 1-3 and one in 1,000 past 2^31, 0/1
        # thresholds as probe_thresholds gives them
        B, F, P, Ln, has_n, mode, share = shape
        thr = ints(0, 2, (P,)).to(torch.int32)
        acc = ints(0, 3, (B, P + 1))
        acc[:, P] = (rand(B) < 0.05).to(torch.int64)
        if mode == "reduced":
            return dict(st=None, valid=None, ovf=None, needles=None, thr=thr, has_n=False,
                        acc=acc)
        N = B * F
        size = torch.where(rand(N) < 0.001, ints(2**31, 2**32, (N,)), ints(1, 4, (N,)))
        st = torch.stack([ints(0, N_TOTAL, (N,)), ints(0, N_TOTAL, (N,)), size,
                          torch.zeros_like(size), ints(0, P, (N,))])
        st = (st - (st >> 31 << 32)).to(torch.int32).view(5, B, F)
        nv = (rand(B, 1) * 2 * share * F).round()
        valid = (torch.arange(F, device=dev)[None, :] < nv).to(torch.uint8)
        needles = ints(0, 4, (B, Ln)).to(torch.uint8)
        if has_n:
            needles[rand(B, Ln) < 0.002] = 4
        return dict(st=st, valid=valid, ovf=(rand(B) < 0.05).to(torch.uint8),
                    needles=needles, thr=thr, has_n=has_n, with_mass=mode == "last",
                    acc=acc if mode in ("acc", "last") else None, last=mode != "acc")
    if kind == "extract_needles":
        B, Ln, has_n = shape
        text = N_TOTAL // 2
        words = ints(-2**31, 2**31 - 1, (text // 16 + 1,)).to(torch.int32)
        nwords = ints(-2**31, 2**31 - 1, (text // 32 + 1 if has_n else 0,)).to(torch.int32)
        return dict(words=words, nwords=nwords, starts=ints(0, text - Ln, (B,)).to(torch.int32),
                    Ln=Ln, limit=text, text_limit=text)
    if kind == "gather_states":
        B, npad, n, Fc, Fe = shape
        st = ints(-2**31, 2**31 - 1, (4, B, Fc)).to(torch.int32)
        valid = (rand(B, Fc) < 0.5).to(torch.uint8)
        ridx = torch.zeros(npad, dtype=torch.int32, device=dev)
        ridx[:n] = ints(0, B, (n,)).to(torch.int32)
        return dict(st=st, valid=valid, ridx=ridx, n=n, Fe=Fe)
    if kind == "compact":
        R, rows, M, F, count, dmax = shape
        arrays = ints(-2**31, 2**31 - 1, (R, rows, M)).to(torch.int32)
        valid = (rand(rows, M) < rand(rows, 1) * dmax).to(torch.uint8)
        return dict(arrays=arrays, valid=valid, F=F, count=count)
    B, J, Fe, exact, share = shape
    N = B * J * Fe
    # each k-mer's valid states first, as compaction leaves them
    nv = (rand(B * J, 1) * 2 * share * Fe).round()
    valid = (torch.arange(Fe, device=dev)[None, :] < nv).to(torch.uint8).reshape(-1)
    flo = ints(0, N_TOTAL - 5000, (N,))
    st = torch.stack([flo, ints(0, N_TOTAL - 5000, (N,)), ints(1, 5000, (N,)),
                      ints(0, 3, (N,))]).to(torch.int32)
    strand = ints(-2**31, 2**31 - 1, (N_TOTAL // 128 + 1, 5)).to(torch.int32)
    cnt = ints(0, J + 1, (B,)).to(torch.int32)
    return dict(index=types.SimpleNamespace(strand_blocks=strand), st=st, valid=valid,
                cnt=cnt, J=J, cap=255, rev_compl=True, with_exact=exact)


def kernel_cases(only):
    """(seed offset, label, kind, shape) of the KERNEL_CASES of the kernels
    in `only` (None: all)."""
    return [(n, label, kind, shape) for n, (label, kind, shape) in enumerate(KERNEL_CASES)
            if only is None or kind in only]


def build_variants(kernels, only):
    """VARIANTS' libraries (one nvcc per variant, all started together):
    ({kernel: [(tag, Kernel)]}, each Kernel bound to its own library, and
    {"kernel tag": ptxas lines})."""
    import hashlib

    built, procs, ptxas = {}, [], {}
    for name, sweep in VARIANTS.items():
        if only is not None and name not in only:
            continue
        base = kernels.KERNELS[name]
        stem, ext = os.path.splitext(base.lib_path())
        for defs in sweep:
            tag = ",".join(f"{k}={v}" for k, v in defs.items())
            path = f"{stem}-{hashlib.sha256(tag.encode()).hexdigest()[:8]}{ext}"
            k = kernels.Kernel(base.name, base.source, base.replaces, None, base.entries)
            k.lib_path = lambda path=path: path
            built.setdefault(name, []).append((tag, k))
            if not os.path.exists(path):
                cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *(f"-D{d}={v}" for d, v in
                                                              defs.items()),
                       "-I", kernels.CSRC, "-o", f"{path}.tmp", base.source_path]
                procs.append((f"{name} {tag}", path,
                              subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT)))
    for label, path, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{log[-4000:]}")
        os.replace(f"{path}.tmp", path)
        ptxas[label] = [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
    return built, ptxas


def time_kernel_cases(kernels, here, sweep, indexes, only):
    """In a child process: each KERNEL_CASES case timed with the imported
    `kernels` (this checkout's or another's), with a hash of its outputs
    (gather_states beside index_select, probe_mass beside scatter_add); with `sweep`, the cases of each
    kernel in VARIANTS in each of its variants (outputs equal to the
    kernel's; the variants' and the kernels' ptxas lines returned) and
    COMPACT_SWEEP under each forced regime."""
    import hashlib
    import importlib.util

    import torch

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    cs = load("chip_smoke_ab", os.path.join(here, "chip_smoke.py"))
    # this checkout's contract view, whichever checkout's kernels are timed
    contract = load("kernels_contract", os.path.join(here, "genmap_tpu_torch", "kernels.py"))
    dev = torch.device("cuda")
    reports = kernels.build([kernels.KERNELS[k] for k in
                             ("candidate_step", "dimer_step", "extract_needles", "compact",
                              "count_tail", "gather_states", "locate", "seed_lookup",
                              "probe_mass", "seed_build", "row_gather")
                             if k in kernels.KERNELS and (only is None or k in only)])
    variants, ptxas = build_variants(kernels, only) if sweep else ({}, {})
    for name, rep in reports.items():
        ptxas[name] = [ln.strip() for ln in rep.splitlines()
                       if "registers" in ln or "spill" in ln]

    def digest(kind, out, args):
        out = out if isinstance(out, tuple) else (out,)
        if kind in ("candidate_step", "dimer_step"):
            out = getattr(contract, f"{kind}_view")(out, **args)
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def seed_tables(index, t0):  # the checkout's own build, whatever it runs
        built = kernels.rank.with_seed_tables(index, t0)
        return built.seed_mlo, built.seed_size

    def row_gather(entry, table, idx, chunk, lanes=None):  # lanes None: the default
        kw = {} if lanes is None else dict(lanes=lanes)
        if entry == "sum":
            return kernels.row_gather_sum(table, idx, chunk, **kw)
        return kernels.row_gather_chain(table, idx, 8, **kw)

    res = []
    for n, label, kind, shape in kernel_cases(only):
        args = kernel_inputs(kind, shape, dev, 2026 + n, indexes)
        fn = {"seed_build": seed_tables, "row_gather": row_gather}.get(
            kind, getattr(kernels, kind, None))
        sha = digest(kind, fn(**args), args)
        row = dict(label=label, ms=cs.device_ms(lambda: fn(**args)),
                   warm=cs.device_ms(lambda: fn(**args), cold=False), sha=sha)
        if kind == "seed_build":
            row.update(seed_build_split(kernels, cs, fn, args),
                       upload_s=upload_seconds(kernels, indexes[shape[0]]))
        if kind == "row_gather":  # every lanes value of this checkout
            row["lanes"] = {}
            for lanes in kernels.ROW_GATHER_LANES:
                if digest(kind, row_gather(**args, lanes=lanes), args) != sha:
                    raise AssertionError(f"row_gather lanes {lanes}: outputs differ at {label}")
                row["lanes"][str(lanes)] = cs.device_ms(lambda: row_gather(**args, lanes=lanes))
        lib = (cs.library_fn(kind, args) if kind in ("gather_states", "probe_mass")
               else None)
        if lib is not None:
            row["library"] = cs.device_ms(lib)
        if sweep and kind in ("candidate_step", "dimer_step"):
            # a floor for the valid2 and far bytes every state costs: two
            # memsets of them (PyTorch's fill kernels)
            width = args["index"].nchars if kind == "candidate_step" else 16
            v2 = torch.empty((args["valid"].numel(), width), dtype=torch.uint8, device=dev)
            far = torch.empty(args["valid"].shape, dtype=torch.uint8, device=dev)
            row["memset"] = cs.device_ms(lambda: (v2.zero_(), far.zero_()))
            del v2, far
        # the wrapper launches the module's kernel object: swap in each variant
        main = getattr(kernels, kind.upper(), None)
        # row_gather's variants change the bulk copies only (lanes 0)
        vfn = (lambda: row_gather(**args, lanes=0)) if kind == "row_gather" else (
            lambda: fn(**args))
        for tag, k in variants.get(kind, ()):
            setattr(kernels, kind.upper(), k)
            try:
                if digest(kind, vfn(), args) != sha:
                    raise AssertionError(f"{kind} {tag}: outputs differ at {label}")
                row[f"var:{tag}"] = cs.device_ms(vfn)
            finally:
                setattr(kernels, kind.upper(), main)
        res.append(row)
        del args
    if sweep and (only is None or "compact" in only):
        chunks = kernels.compact_chunks
        for n, shape in enumerate(COMPACT_SWEEP):
            args = kernel_inputs("compact", shape, dev, 4096 + n)
            R, rows, M, F, _count, dmax = shape
            long_nch = -(-((M + 15) // 16 + 1) // kernels.COMPACT_CHUNK_UNITS)
            ms = {}
            for regime, nch in (("middle", 0), ("long", long_nch)):
                kernels.compact_chunks = lambda m, nch=nch: nch
                ms[regime] = cs.device_ms(lambda: kernels.compact(**args))
            kernels.compact_chunks = chunks
            res.append(dict(label=f"sweep R={R} rows={rows} M={M} F={F} density<{dmax}",
                            default=("long" if chunks(M) else "middle"), **ms))
            del args
    res.append(dict(ptxas=ptxas))
    return res


def seed_build_split(kernels, cs, fn, args) -> dict:
    """Where one seed-table build's time goes: its launches (by kernel), the
    peak device bytes it allocates above what was allocated before, the
    host's issue time (no sync), and under torch.profiler the device ms of
    the port's kernels and of PyTorch's own device ops, beside the profiled
    call's wall time (to a synchronize)."""
    import time

    import torch

    torch.cuda.synchronize()
    kernels.reset_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn(**args)
    issue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    del out
    wall, calls, _by_sym, other_ms, n_other = cs.profiled_device_times(lambda: fn(**args))
    return dict(launches=launches, peak_bytes=peak, host_issue_ms=issue_ms,
                profiled_wall_ms=wall * 1e3,
                kernel_ms={k: float(sum(v)) for k, v in calls.items()},
                kernel_calls={k: len(v) for k, v in calls.items()},
                launch_ms={k: [round(float(x), 5) for x in v] for k, v in calls.items()},
                other_ms=other_ms, other_ops=n_other)


def upload_seconds(kernels, path, reps: int = 3) -> float:
    """Median host seconds of one `DeviceIndex.from_part` of the index at
    `path` (light: the rank rows, text-free; the seed tables built), to a
    synchronize; the host index is loaded once before."""
    import time

    import torch

    from genmap_tpu_torch.index.fmindex import FMIndexData

    data = FMIndexData.load(path)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        kernels.rank.DeviceIndex.from_part(data, data.parts[0], light=True, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times[1:]))


def build_locate_indexes(work, keys) -> dict:
    """The indexes of `keys` (of "main", "dna5", "large"), built with this
    checkout's `genmap-tpu-torch index` into `work`: key -> index
    directory."""
    import time

    sys.path.insert(0, HERE)
    import chip_smoke
    from genmap_tpu_torch.cli.main import main as cli_main
    from genmap_tpu_torch.corpus import make_genomelike

    def dna5():
        rng = np.random.default_rng(chip_smoke.SEED + 1)
        codes = make_genomelike(chip_smoke.DNA5_BP, seed=chip_smoke.SEED + 1)
        for s in rng.integers(0, len(codes) - 2000, 40):  # N runs, as the smoke's
            codes[s : s + int(rng.integers(10, 1500))] = 4
        return [("chrK", codes)]

    genomes = {"main": chip_smoke.yeast_like_genome, "dna5": dna5,
               "large": lambda: [("chrL", make_genomelike(LARGE_BP, seed=chip_smoke.SEED + 2))]}
    paths = {}
    for key in keys:
        t = time.perf_counter()
        chroms = genomes[key]()
        fa = os.path.join(work, f"{key}.fa")
        chip_smoke.write_fasta(fa, chroms)
        paths[key] = os.path.join(work, f"idx_{key}")
        if cli_main(["index", "-F", fa, "-I", paths[key]]) != 0:
            raise RuntimeError(f"index of {key} failed")
        print(f"kernels: the {key} index ({sum(len(c) for _, c in chroms)} bp) built "
              f"in {time.perf_counter() - t:.1f} s", flush=True)
    return paths


def run_kernels(other, only) -> int:
    """--kernels: A B B A processes; per case each process's ms, the
    median ratio A / B, and the sweep of this checkout's processes."""
    # locate walks all three indexes, seed_lookup reads the main one's tables
    keys = [key for key, users in (("main", {"locate", "seed_lookup", "seed_build"}),
                                   ("dna5", {"locate", "seed_build"}),
                                   ("large", {"locate", "seed_build"}))
            if only is None or users & set(only)]
    with tempfile.TemporaryDirectory(prefix="genmap_abk_") as work:
        return _run_kernels(other, build_locate_indexes(work, keys) if keys else {}, only)


def _run_kernels(other, indexes, only) -> int:
    order = [("A", os.path.abspath(other)), ("B", HERE), ("B", HERE), ("A", os.path.abspath(other))]
    results = {}
    for key, root in order:
        r = subprocess.run([sys.executable, "-c", KCHILD, root, HERE, str(int(key == "B")),
                            json.dumps(indexes), json.dumps(only)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        results.setdefault(key, []).append(json.loads(r.stdout.strip().splitlines()[-1]))
    summary = {"cases": {}, "sweep": {}}
    cases = kernel_cases(only)
    for i, (_n, label, _kind, shape) in enumerate(cases):
        runs = {k: [p[i] for p in ps] for k, ps in results.items()}
        shas = {x["sha"] for rs in runs.values() for x in rs}
        if len(shas) != 1:
            print(f"{label}: outputs differ between processes: {shas}", file=sys.stderr)
            return 1
        a = [x["ms"] for x in runs["A"]]
        b = [x["ms"] for x in runs["B"]]
        wa = [x["warm"] for x in runs["A"]]
        wb = [x["warm"] for x in runs["B"]]
        extra = {k: [x[k] for x in runs["B"]] for k in runs["B"][0]
                 if k.startswith("var:") or k == "memset"}
        details = {p: [{k: x[k] for k in x if k not in ("label", "ms", "warm", "sha")
                        and not k.startswith("var:") and k != "memset"} for x in runs[p]]
                   for p in ("A", "B")}
        lib = [x["library"] for p in ("A", "B") for x in runs[p] if "library" in x]
        summary["cases"][label] = dict(shape=shape, A_ms=a, B_ms=b, A_warm_ms=wa, B_warm_ms=wb,
                                       A_over_B=float(np.median(a) / np.median(b)),
                                       **({"library_ms": lib} if lib else {}),
                                       **{f"B_{k}": v for k, v in extra.items()},
                                       details=details)
        print(f"kernels: {label} {shape}: A {a[0]:.4f} / {a[1]:.4f} ms, B {b[0]:.4f} / "
              f"{b[1]:.4f} ms, A/B {np.median(a) / np.median(b):.2f}x (outputs equal); "
              f"L2 warm: A {wa[0]:.4f} / {wa[1]:.4f} ms, B {wb[0]:.4f} / {wb[1]:.4f} ms"
              + (f"; library (A A B B processes) "
                 f"{' / '.join(f'{x:.4f}' for x in lib)} ms" if lib else "")
              + "".join(f"; B {k.removeprefix('var:')} {v[0]:.4f} / {v[1]:.4f} ms"
                        for k, v in extra.items()), flush=True)
        for p in ("A", "B"):
            for d in details[p]:
                if d:
                    print(f"kernels:   {p}: {json.dumps(d)}", flush=True)
    n = len(cases)
    for j in range(len(COMPACT_SWEEP) if only is None or "compact" in only else 0):
        rows = [p[n + j] for p in results["B"]]
        mid = [x["middle"] for x in rows]
        lng = [x["long"] for x in rows]
        summary["sweep"][rows[0]["label"]] = dict(middle_ms=mid, long_ms=lng,
                                                  default=rows[0]["default"])
        print(f"kernels: {rows[0]['label']}: middle {mid[0]:.4f} / {mid[1]:.4f} ms, long "
              f"{lng[0]:.4f} / {lng[1]:.4f} ms (default {rows[0]['default']})", flush=True)
    ptxas = results["B"][0][-1]["ptxas"]
    for label, lines in sorted(ptxas.items()):
        print(f"kernels: ptxas {label}: {' | '.join(lines)}", flush=True)
    summary["ptxas"] = ptxas
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    summary["card"] = smi.stdout.strip()
    print(json.dumps(summary))
    return 0


def run_order(work, idx, order, runs, k, e, tag, busy):
    """Run the processes of `order` ((key, root, probe, dimer) each) at
    (k, e); returns {key: [run, ...]}, or None when one fails."""
    results = {}
    for n, (key, root, probe, dimer) in enumerate(order):
        out = os.path.join(work, f"{tag}_out{n}")
        os.makedirs(out)
        r = subprocess.run([sys.executable, "-c", CHILD, root, idx, out, str(runs),
                            probe, dimer, str(k), str(e), str(int(busy)), HERE],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return None
        rs = json.loads(r.stdout.strip().splitlines()[-1])
        results.setdefault(key, []).extend(rs)
        kps = [x["n_kmers"] / x["compute_s"] for x in rs]

        def col(vals, fmt):
            return ", ".join(format(v, fmt) for v in vals)

        mode = (f"probe {'on' if probe == '1' else 'off'}, dimer {dimer}")
        print(f"({k},{e}) {key} ({mode}, {root}): k-mers/s {col(kps, '.0f')}; dispatch "
              f"{col([x['dispatch_s'] for x in rs], '.2f')} s; fetch "
              f"{col([x['fetch_s'] for x in rs], '.2f')} s; batches "
              f"{rs[0]['batches']}; launches {rs[0]['launches']}; peak allocated "
              f"{rs[0]['peak_bytes']} B; device busy (profiled map) {rs[0]['busy_share']}, "
              f"device ms per map {rs[0]['device_ms_per_map']}; calls, median and "
              f"p90 ms per call {rs[0]['calls_median_p90_ms']}; "
              f"dimer tier 0 {rs[0]['dimer_tier']}; blocks per "
              f"tier {rs[0]['tier_blocks']}; probe skipped {rs[0]['probe_skipped']}",
              flush=True)
    shas = {x["sha"] for rs in results.values() for x in rs}
    if len(shas) != 1:
        print(f"({k},{e}): frequencies differ between processes: {shas}", file=sys.stderr)
        return None
    return results


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("other", nargs="?")
    p.add_argument("--dimer", action="store_true",
                   help="dimer tiers as by default against mono rows only")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--busy", action="store_true",
                   help="also profile one map per process (device ms per kernel, busy share)")
    p.add_argument("--kernels", action="store_true",
                   help="time the kernels against OTHER_CHECKOUT's (no map)")
    p.add_argument("--only", help="with --kernels: these kernels only (comma-separated)")
    args = p.parse_args()
    if args.dimer == (args.other is not None):
        p.error("give either OTHER_CHECKOUT or --dimer")
    if args.kernels:
        if args.other is None:
            p.error("--kernels needs OTHER_CHECKOUT")
        return run_kernels(args.other, args.only.split(",") if args.only else None)
    sys.path.insert(0, HERE)
    import chip_smoke
    from genmap_tpu_torch.cli.main import main as cli_main

    summary = {}
    with tempfile.TemporaryDirectory(prefix="genmap_ab_") as work:
        fa = os.path.join(work, "yeastlike.fa")
        chip_smoke.write_fasta(fa, chip_smoke.yeast_like_genome())
        idx = os.path.join(work, "idx")
        if cli_main(["index", "-F", fa, "-I", idx]) != 0:
            return 1
        if args.dimer:
            order = [("A", HERE, "1", "auto"), ("B", HERE, "1", "off")]
            cells = [(100, 2, order + order[::-1]), (24, 1, order + order[::-1])]
        else:
            order = [("A", os.path.abspath(args.other), "1", "auto"),
                     ("B", HERE, "1", "auto"), ("C", HERE, "0", "auto")]
            # (24,1) runs no probe (J = 6): C would equal B there
            cells = [(100, 2, order + order[::-1]), (24, 1, order[:2] + order[1::-1])]
        for k, e, cell_order in cells:
            results = run_order(work, idx, cell_order, args.runs, k, e, f"{k}_{e}",
                                args.busy)
            if results is None:
                return 1
            summary[f"{k},{e}"] = {
                key: dict(kmers_per_s_median=float(np.median(
                    [x["n_kmers"] / x["compute_s"] for x in rs])), runs=rs)
                for key, rs in results.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    summary["card"] = smi.stdout.strip()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
