"""Random rank-row reads on the GPU: the port of
`benchmarks/pallas_experiments.py`.

    python -m genmap_tpu_torch.experiments.row_gather [--device cuda|cpu] [--quick]

That harness holds the repo's one Pallas kernel, `pallas_dma_sum`
(`benchmarks/pallas_experiments.py:106-122`, body `dma_kernel` `:81-104`:
per-row DMA of `table[idx[r], :]` for the first (ND // CHUNK) * CHUNK ids,
every int32 summed into one wrapping int32), beside its baseline `xla_chain`
(`:72-78`: 8 dependent `jnp.take` row reads from each of 2^17 ids).  Here
both run as the `row_gather` CUDA kernel (`csrc/row_gather.cu`, entries
`_sum` and `_chain`, wrappers `kernels.row_gather_sum` / `row_gather_chain`).

First the harness's own sizes, built from numpy seed 0 as `:56-68` builds
them (table int32 [31,250, 128] with values in [0, 2^30); 2^17 chain ids;
4,096 DMA ids; CHUNK 128; STEPS 8), printed in the harness's format (name,
ms, Mrows/s, checksum), every `lanes` variant held exactly against the plain
version and the library call.  Then a sweep of the read rate over row
width (64-1,024 B: the rank sub-row, paired-row and dimer-row widths and two
ends), table size (16 MB, 20 MB and 256 MiB, which the 50 MB L2 holds or
not, and 4 GiB, hg38-class mono rows in HBM), ids at random or sorted,
independent (`sum`) or dependent (`chain`) reads, lanes per row (and, at
the rank rows' widths from the 20 MB, 256 MiB and 4 GiB tables, lanes 0: whole rows
moved by the copy engine into shared memory, as the harness's per-row DMAs
move them into VMEM), and blocks per SM: rows/s and GB/s of row bytes
beside each call's byte bound.

The device is cuda unless `--device cpu` is given; without a card a cuda
run raises.  On the CPU the wrappers take the plain versions and times are
host times.  `--quick` shrinks every size (the tests' run); the full sweep
(a 4 GiB table) runs on the card only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from genmap_tpu_torch import kernels
from genmap_tpu_torch.ops.rank import resolve_device

H100_BYTES_PER_S = 3.35e12  # HBM3 peak of one H100 SXM (NVIDIA data sheet)
LANES = kernels.ROW_GATHER_LANES

# the harness's sizes (benchmarks/pallas_experiments.py:56-68) and a CPU-sized
# set with a DMA id count that is no multiple of CHUNK
HARNESS = dict(NR=31_250, W=128, N=1 << 17, STEPS=8, ND=1 << 12, CHUNK=128)
QUICK_HARNESS = dict(NR=997, W=128, N=4096, STEPS=8, ND=700, CHUNK=128)

SWEEP_ROW_BYTES = (64, 208, 276, 416, 512, 552, 1024)
SWEEP_TABLES = (("16 MB", 16_000_000), ("20 MB", 20_000_000),
                ("256 MiB", 256 << 20), ("4 GiB", 4 << 30))
QUICK_TABLES = (("64 KiB", 64 << 10), ("1 MiB", 1 << 20))
SWEEP_LANES = (1, 8, 32)
# the bulk copies (lanes 0) are swept at the rank rows' widths (Dna4 and
# Dna5 sub-rows, the Dna4 paired row, the dimer row) from an L2-sized and
# two HBM-sized tables (in --quick: from both quick tables)
BULK_ROW_BYTES = (208, 276, 416, 512)
BULK_TABLES = ("20 MB", "256 MiB", "4 GiB")
SWEEP_BLOCKS_PER_SM = (1, 2, 4, 8)  # 256-thread blocks; 8 fill an SM's 2,048 threads
SWEEP_SEED = 2026


def harness_inputs(NR: int, W: int, N: int, ND: int, seed: int = 0):
    """(table, chain ids, DMA ids) as numpy int32, drawn in the harness's
    order from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**30, size=(NR, W), dtype=np.int64).astype(np.int32)
    idx0 = rng.integers(0, NR, size=N).astype(np.int32)
    idx_d = rng.integers(0, NR, size=ND).astype(np.int32)
    return table, idx0, idx_d


def negative_wrap_table(NR: int, W: int, seed: int) -> np.ndarray:
    """An int32 [NR, W] table whose every row sum, wrapped to int32, is
    negative (the last column is set to reach a negative target)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 2**30, size=(NR, W), dtype=np.int64)
    target = rng.integers(-2**31, 0, size=NR, dtype=np.int64)
    t[:, -1] = (target - t[:, :-1].sum(axis=1)) % 2**32
    return t.astype(np.uint32).view(np.int32)


_FLUSH = []


def device_ms(fn, reps: int = 10) -> float:
    """Median device time of one fn() call in ms (CUDA events), each call
    queued behind a 256 MiB write that evicts the 50 MB L2, so that no table
    starts in L2 and the host's issue time is hidden."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        _FLUSH[0].zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        ev.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def host_ms(fn, reps: int = 3) -> float:
    """Best host time of one fn() call in ms (the harness's own method)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def _timer(dev):
    return device_ms if dev.type == "cuda" else host_ms


def _clock(dev) -> str:
    return "device ms, L2 flushed" if dev.type == "cuda" else "host ms on the cpu"


def _library(kind: str, table, ids, steps: int, n_used: int):
    """One PyTorch call (for the chain, its loop) computing the function."""
    if kind == "sum":
        sel = ids[:n_used]
        return lambda: torch.index_select(table, 0, sel).sum(dtype=torch.int64)
    return lambda: kernels.row_gather_chain_plain(table, ids, steps)


def _measure(dev, kind: str, table, ids, *, steps: int = 8, chunk: int = 1,
             lanes_list=LANES, blocks: int = 0) -> dict:
    """Every lanes variant held against the plain version (exactly) and the
    library call, then timed; returns the figures of each variant."""
    NR, W = table.shape
    if kind == "sum":
        n_used = ids.shape[0] // chunk * chunk
        fn, plain = kernels.row_gather_sum, kernels.row_gather_sum_plain
        extra = dict(chunk=chunk)
        n_reads = n_used
        distinct = int(torch.unique(ids[:n_used]).numel())
    else:
        n_used = ids.shape[0]
        fn, plain = kernels.row_gather_chain, kernels.row_gather_chain_plain
        extra = dict(steps=steps)
        n_reads = n_used * steps
        path = kernels.row_gather_chain_steps(table, ids, steps)[:-1]
        distinct = int(torch.unique(torch.cat(path)).numel()) if path else 0
    want = int(plain(table, ids, **extra))
    lib = _library(kind, table, ids, steps, n_used)
    if kind == "sum":
        lib_val = int(lib()) & 0xFFFFFFFF
        if lib_val != want & 0xFFFFFFFF:
            raise AssertionError(f"row_gather {kind}: library {lib_val} != plain {want}")
    timer = _timer(dev)
    default = kernels.row_gather_lanes(table, n_used)
    out = dict(kind=kind, NR=NR, row_bytes=4 * W, reads=n_reads, distinct=distinct,
               checksum=want, lanes={}, default_lanes=default)
    for lanes in sorted(set(lanes_list) | {default}):
        got = int(fn(table, ids, lanes=lanes, blocks=blocks, **extra))
        if got != want:
            raise AssertionError(f"row_gather {kind} (NR={NR} W={W} lanes={lanes} "
                                 f"blocks={blocks}): kernel {got} != plain {want}")
        out["lanes"][lanes] = timer(lambda: fn(table, ids, lanes=lanes, blocks=blocks,
                                               **extra))
    out["plain_ms"] = timer(lambda: plain(table, ids, **extra))
    out["library_ms"] = timer(lib)
    nbytes = distinct * 4 * W + 4 * n_used + 4  # distinct rows, the ids, the sum
    out["bytes"] = nbytes
    out["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
    return out


def run_harness(dev, quick: bool = False, say=print) -> dict:
    """The harness's two lines at its own sizes (or the quick ones)."""
    h = QUICK_HARNESS if quick else HARNESS
    table, idx0, idx_d = (torch.from_numpy(a).to(dev) for a in
                          harness_inputs(h["NR"], h["W"], h["N"], h["ND"]))
    res = {}
    for name, kind, ids, kw, rows in (
        ("row_gather_chain (8-step chain)", "chain", idx0, dict(steps=h["STEPS"]),
         h["N"] * h["STEPS"]),
        ("row_gather_sum (1 pass)        ", "sum", idx_d, dict(chunk=h["CHUNK"]),
         h["ND"] // h["CHUNK"] * h["CHUNK"]),
    ):
        r = _measure(dev, kind, table, ids, **kw)
        ms = r["lanes"][r["default_lanes"]]
        say(f"{name}: {ms:9.4f} ms  {rows / ms / 1e3:7.1f} Mrows/s  (checksum "
            f"{r['checksum']}; lanes {r['default_lanes']}, the default)")
        say(f"  {kind}: NR={h['NR']} W={h['W']} ids={ids.shape[0]} ({r['reads']} row "
            f"reads of {r['distinct']} distinct rows), {_clock(dev)}: lanes "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["lanes"].items())
            + f"; plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}; bound "
            f"{r['bound_ms']:.5f} ms by bytes ({r['bytes']} B); every lanes variant "
            "equal to plain")
        res[kind] = r
    return res


def sweep(dev, quick: bool = False, say=print) -> list[dict]:
    """Read rates over row width, table size, id order, dependence, lanes
    and blocks per SM; each call held exactly against the plain version."""
    tables = QUICK_TABLES if quick else SWEEP_TABLES
    n_sum, n_chain, steps = ((4096, 512, 8) if quick else (1 << 20, 1 << 17, 8))
    gen = torch.Generator(device=dev).manual_seed(SWEEP_SEED)
    flat = torch.randint(0, 2**30, (max(b for _, b in tables) // 4,),
                         dtype=torch.int32, device=dev, generator=gen)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    rows = []

    def lanes_for(label, table):
        bulk = label in BULK_TABLES or quick
        return SWEEP_LANES + ((0,) if bulk and 4 * table.shape[1] in BULK_ROW_BYTES else ())

    def design(lanes, table, kind):
        if lanes:
            return f"lanes {lanes:2d}"
        if kernels.row_gather_bulk(table, kind):
            return "lanes  0 (bulk copies)"
        return (f"lanes  0 (the copies do not apply: the word kernel, lanes "
                f"{kernels.row_gather_word_lanes(table)})")

    def report(label, r, pattern, blocks_label, table):
        for lanes, ms in r["lanes"].items():
            rate = r["reads"] / (ms * 1e-3)
            gbps = r["reads"] * r["row_bytes"] / (ms * 1e-3) / 1e9
            row = dict(table=label, row_bytes=r["row_bytes"], NR=r["NR"], kind=r["kind"],
                       pattern=pattern, lanes=lanes, blocks=blocks_label, ms=ms,
                       rows_per_s=rate, gb_per_s=gbps, bound_ms=r["bound_ms"],
                       library_ms=r["library_ms"], reads=r["reads"],
                       distinct=r["distinct"],
                       bulk=not lanes and kernels.row_gather_bulk(table, r["kind"]))
            rows.append(row)
            say(f"sweep: {r['kind']:5s} {pattern:6s} {label:>7s} table, "
                f"{r['row_bytes']:4d} B rows (NR {r['NR']}), {design(lanes, table, r['kind'])}, blocks "
                f"{blocks_label}: {r['reads']} reads of {r['distinct']} distinct rows "
                f"in {ms:.4f} {_clock(dev)}: {rate:.3e} rows/s, {gbps:.1f} GB/s of row "
                f"bytes; bound {r['bound_ms']:.5f} ms by bytes ({r['bytes']} B, "
                f"{100 * r['bound_ms'] / ms:.1f}% of it); library {r['library_ms']:.4f} ms")

    for label, nbytes in tables:
        for rb in SWEEP_ROW_BYTES:
            W = rb // 4
            NR = nbytes // rb
            table = flat[:NR * W].view(NR, W)
            ids = torch.randint(0, NR, (n_sum,), dtype=torch.int32, device=dev,
                                generator=gen)
            lanes = lanes_for(label, table)
            for pattern, x in (("random", ids), ("sorted", torch.sort(ids).values)):
                report(label, _measure(dev, "sum", table, x, lanes_list=lanes),
                       pattern, "auto", table)
            ids = torch.randint(0, NR, (n_chain,), dtype=torch.int32, device=dev,
                                generator=gen)
            report(label, _measure(dev, "chain", table, ids, steps=steps,
                                   lanes_list=lanes), "random", "auto", table)
    # rows in flight: the grid set to a few blocks per SM ("auto" above is
    # one id per row group capped at the blocks the card holds at once), at
    # 416 B rows (the port's Dna4 paired row), from an L2-sized and the
    # largest table
    rb = 416
    for label, nbytes in (tables[1], tables[-1]):
        NR = nbytes // rb
        table = flat[:NR * (rb // 4)].view(NR, rb // 4)
        ids = torch.randint(0, NR, (n_sum,), dtype=torch.int32, device=dev, generator=gen)
        for bps in SWEEP_BLOCKS_PER_SM:
            report(label, _measure(dev, "sum", table, ids, lanes_list=SWEEP_LANES,
                                   blocks=bps * sms), "random", f"{bps}/SM", table)
    return rows


def run(dev, quick: bool = False, say=print) -> dict:
    """The harness's lines, then (on the card, or with `quick`) the sweep."""
    dev = resolve_device(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"row_gather on {name} ({'quick sizes' if quick else 'full sizes'})")
    res = {"harness": run_harness(dev, quick, say)}
    if dev.type == "cuda" or quick:
        res["sweep"] = sweep(dev, quick, say)
    else:
        say("sweep: its 4 GiB table runs on the card only (--quick runs it "
            "at CPU size)")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m genmap_tpu_torch.experiments.row_gather",
                                description="Random rank-row read rates (the port of "
                                            "benchmarks/pallas_experiments.py).")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--quick", action="store_true",
                   help="small sizes throughout (CPU-sized)")
    args = p.parse_args(argv)
    run(args.device, quick=args.quick)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
