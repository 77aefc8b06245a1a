"""Host orchestrator: per-file (k,e)-frequency computation on the device.

Port of `genmap_tpu/engine/mappability.py` for a single-part index on one
device: block decomposition of a file (or of a BED selection), the batch
loop over the block mapper (search/engine.py), capacity-tier escalation
routed by overflow kind, a rescue pass at the static largest tier, scatter
into the frequency vector and resetLimits.  The unique-infix probe,
same-k-mer dedup, occupancy calibration, the split pipeline and the dimer
table are not part of this port yet; none of them changes a result.

Capability map to the reference (GenMap src/):
  - per-file segmentation loop            mappability.hpp:276-365
  - block decomposition + compute         algo.hpp:405-483
  - resetLimits boundary zeroing          algo.hpp:10-22
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from genmap_tpu_torch.index.fmindex import FMIndexData
from genmap_tpu_torch.ops.rank import DeviceIndex, DeviceText, resolve_device
from genmap_tpu_torch.progress import Progress
from genmap_tpu_torch.search.engine import (
    DEFAULT_TIERS,
    BlockMapper,
    Tier,
    extension_extra_estimate,
    infix_pool_schedule,
)
from genmap_tpu_torch.search.schemes import plans_for

# Two batch-size budgets: WORK bounds the state-slot-steps of one batch,
# SLOTS its peak live state slots (device memory through the candidate
# fan-out).
WORK = 1 << 25
SLOTS = 3 << 20


@dataclass
class SearchParams:
    """Mirrors the reference SearchParams (GenMap src/common.hpp:67-74).

    `overlap` is the length of the common overlap infix (the post-transform
    value of mappability.hpp:543).
    """

    length: int
    overlap: int
    rev_compl: bool = True


@dataclass
class FileLayout:
    """Per-fasta-file view of the index."""

    name: str
    seq_ids: list[int]  # global sequence indices
    chrom_names: list[str]
    chrom_lens: np.ndarray  # int64
    cum_lens: np.ndarray  # int64, leading 0
    start: int  # start offset in the global concatenated text (no sentinels)
    length: int  # total bases in this file


def file_layouts(data: FMIndexData) -> list[FileLayout]:
    layouts: list[FileLayout] = []
    pos = 0
    i = 0
    nseq = data.nseq
    while i < nseq:
        j = i
        while j < nseq and data.seq_files[j] == data.seq_files[i]:
            j += 1
        lens = data.seq_lens[i:j].astype(np.int64)
        cum = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=cum[1:])
        layouts.append(
            FileLayout(
                name=data.seq_files[i],
                seq_ids=list(range(i, j)),
                chrom_names=data.seq_names[i:j],
                chrom_lens=lens,
                cum_lens=cum,
                start=pos,
                length=int(lens.sum()),
            )
        )
        pos += int(lens.sum())
        i = j
    return layouts


def reset_limits(c: np.ndarray, K: int, cum_lens: np.ndarray) -> None:
    """Zero k-mers spanning sequence boundaries (algo.hpp:10-22)."""
    for i in range(1, len(cum_lens)):
        hi = int(cum_lens[i])
        seq_len = int(cum_lens[i] - cum_lens[i - 1])
        for j in range(1, min(K, seq_len + 1)):
            c[hi - j] = 0


@dataclass
class FileResult:
    c: np.ndarray  # uint32 frequency vector (clamped to cap)
    layout: FileLayout


class MappabilityEngine:
    """Single-part, single-device mapping engine.

    Runs on `device` ("cuda" by default; "cpu" takes every kernel's plain
    PyTorch version).  Raises on "cuda" without a card and on multi-part
    indexes (not ported yet)."""

    def __init__(
        self,
        data: FMIndexData,
        batch_blocks: int = 256,
        tiers: tuple[Tier, ...] = DEFAULT_TIERS,
        batch_kmers: int = 0,
        device="cuda",
    ):
        if len(data.parts) != 1:
            raise NotImplementedError(
                f"multi-part indexes ({len(data.parts)} parts) are not yet "
                "ported to genmap_tpu_torch"
            )
        self.device = resolve_device(device)
        self.data = data
        self.batch_blocks = batch_blocks
        self.batch_kmers = batch_kmers
        self.tiers = tuple(tiers)
        self.dtext = DeviceText.from_host(data, self.device)
        # light: the SA samples only serve locate (CSV / -ep), not ported yet
        self.index = DeviceIndex.from_part(data, data.parts[0], light=True,
                                           device=self.device)
        self.layouts = file_layouts(data)
        self._runners: dict = {}
        # per-compute overflow/tier statistics + phase timers (device time
        # lands in fetch_s: the result copy waits for the device)
        self.stats = {
            "overflow_blocks": 0, "max_tier": 0, "batches": 0,
            "dispatch_s": 0.0, "fetch_s": 0.0, "scatter_s": 0.0,
            "tier_blocks": {},  # blocks PROCESSED per tier index
        }

    def resident_bytes(self) -> int:
        """Bytes of index and text held on the device."""
        return self.index.resident_bytes() + self.dtext.resident_bytes()

    def _runner(self, K, errors, o, J, B, tier, cap, rev_compl) -> BlockMapper:
        key = (K, errors, o, J, B, tier, cap, rev_compl)
        if key not in self._runners:
            self._runners[key] = BlockMapper(
                self.index, self.dtext, K=K, errors=errors, overlap=o, J=J,
                B=B, tier=tier, cap=cap, rev_compl=rev_compl,
            )
        return self._runners[key]

    # ------------------------------------------------------------------

    def compute_file(
        self,
        layout: FileLayout,
        params: SearchParams,
        errors: int,
        cap: int,
        intervals: list[tuple[int, int]] | None = None,
        file_no: int = 1,
        total_files: int = 1,
    ) -> FileResult:
        """Compute the frequency vector of one file.

        `intervals` are cumulative [begin, end) position ranges within the
        file (BED selection, mappability.hpp:276-365); None = whole file.
        """
        K = params.length
        o = params.overlap
        J = K - o + 1
        L = layout.length
        c = np.zeros(L, dtype=np.uint32)

        nkmers = L - K + 1
        if nkmers <= 0:
            return FileResult(c=c, layout=layout)

        # block starts + per-block k-mer counts (algo.hpp:434-451)
        if intervals is None:
            starts = np.arange(0, nkmers, J, dtype=np.int64)
            ends = np.minimum(starts + J, nkmers)
        else:
            ss, ee = [], []
            for b, e_ in intervals:
                for i in range(b, e_, J):
                    ss.append(i)
                    ee.append(min(i + J, e_, nkmers))
            starts = np.array(ss, dtype=np.int64)
            ends = np.array(ee, dtype=np.int64)
            keep = ends > starts
            starts, ends = starts[keep], ends[keep]
        cnts = (ends - starts).astype(np.int32)
        if len(starts) == 0:
            return FileResult(c=c, layout=layout)

        progress = Progress(len(starts), file_no, total_files)
        self._execute_blocks(c, layout, starts, cnts, K, o, J, errors, cap,
                             params, progress)
        progress.finish()
        reset_limits(c, K, layout.cum_lens)
        return FileResult(c=c, layout=layout)

    # ------------------------------------------------------------------

    def _execute_blocks(self, c, layout, starts, cnts, K, o, J, errors, cap,
                        params, progress=None):
        """Run the tier-escalating batch loop over the given blocks."""
        self.stats["tier_blocks"] = {}
        plans = plans_for(errors, o)
        n_max = self.index.n_total
        B0 = max(self.batch_blocks, -(-self.batch_kmers // J))

        def block_cost(tier):
            """(time_cost, peak_slots) per block at this tier: time ~ the
            state slots stepped (pool sizes plus extension steps), memory ~
            the widest live state tensor."""
            levels = max(1, math.ceil(math.log2(max(2, J))))
            pools = infix_pool_schedule(plans, K - o, n_max, tier.f_search / 4.0)
            cost = int(pools.sum()) + J * levels * tier.f_extend
            peak = max(int(pools.max()), J * tier.f_extend)
            return cost, peak

        tiers = list(self.tiers)
        if (
            tiers[0].f_extend < 4
            and extension_extra_estimate(plans, K - o, n_max) > 0.02
        ):
            # branch survivors of the infix are expected: start the extension
            # frontier at 4 slots instead of overflowing most blocks
            tiers[0] = dataclasses.replace(tiers[0], f_extend=4)

        # tier routing: capacity-overflow blocks skip ahead to the next tier
        # whose capacities are actually LARGER than the program they just
        # overflowed; far-only blocks (fast-rank window misses) go to the
        # next tier, whose same-capacity exact program suffices for them
        def tier_caps(i):
            pools_i = infix_pool_schedule(plans, K - o, n_max,
                                          tiers[i].f_search / 4.0)
            return (int(pools_i.sum()), tiers[i].f_extend, tiers[i].f_collect)

        caps_by_tier = [tier_caps(i) for i in range(len(tiers))]

        def next_cap_tier(i):
            for j in range(i + 1, len(tiers)):
                if any(a > b for a, b in zip(caps_by_tier[j], caps_by_tier[i])):
                    return j
            return None

        def tier_B(t_j, npend):
            cost, peak = block_cost(tiers[t_j])
            B = max(8, min(B0, WORK // max(1, cost), SLOTS // max(1, peak)))
            if t_j == 0:
                # shrink (power-of-two quantized) when few blocks remain
                if npend < B:
                    B = min(B, max(256, 1 << int(np.ceil(np.log2(max(2, npend))))))
            else:
                # escalation cohorts: three budget-bounded batch rungs
                if npend >= 8 * 4096:
                    rung = 16384
                elif npend >= 2048:
                    rung = 4096
                else:
                    rung = 1024
                B = min(B, rung)
            return B

        pending_at = [np.empty(0, np.int64) for _ in tiers]
        pending_at[0] = np.arange(len(starts), dtype=np.int64)
        # unresolved blocks, split by whether they actually RAN at the last
        # tier (vs. fell off the routing table earlier) — decides whether the
        # static rescue pass can still help
        unresolved_ran_last: list[np.ndarray] = []
        unresolved_other: list[np.ndarray] = []
        for t_i, tier in enumerate(tiers):
            pending = pending_at[t_i]
            if len(pending) == 0:
                continue
            B = tier_B(t_i, len(pending))
            run = self._runner(K, errors, o, J, B, tier, cap, params.rev_compl)
            far_blocks, cap_blocks = self._run_blocks(
                run, pending, B, c, layout, starts, cnts, K, J, t_i,
                progress if t_i == 0 else None,
            )
            if len(far_blocks):
                if t_i + 1 < len(tiers):
                    pending_at[t_i + 1] = np.concatenate(
                        [pending_at[t_i + 1], far_blocks]
                    )
                else:
                    unresolved_ran_last.append(far_blocks)
            if len(cap_blocks):
                j = next_cap_tier(t_i)
                if j is None:
                    (unresolved_ran_last if t_i == len(tiers) - 1
                     else unresolved_other).append(cap_blocks)
                else:
                    pending_at[j] = np.concatenate([pending_at[j], cap_blocks])
        if unresolved_ran_last or unresolved_other:
            # Rescue pass: the ladder's results contract is the STATIC final
            # schedule.  Blocks that fell off the routing table before the
            # last tier, or overflowed a modified last tier, get one pass at
            # the static largest tier of this engine's ladder before we fail.
            last = len(tiers) - 1
            pristine = self.tiers[-1]
            last_was_static = tiers[last] == pristine
            rescue = unresolved_other + (
                [] if last_was_static else unresolved_ran_last
            )
            still = list(unresolved_ran_last if last_was_static else [])
            if rescue:
                ids = np.unique(np.concatenate(rescue))
                cost, peak = block_cost(pristine)
                B = max(8, min(B0, WORK // max(1, cost), SLOTS // max(1, peak), 1024))
                run = self._runner(K, errors, o, J, B, pristine, cap,
                                   params.rev_compl)
                far_b, cap_b = self._run_blocks(
                    run, ids, B, c, layout, starts, cnts, K, J, last, None
                )
                still += [far_b, cap_b]
            n_still = sum(len(a) for a in still)
            if n_still:
                raise RuntimeError(
                    f"{n_still} blocks overflowed the largest frontier tier"
                )

    def _run_blocks(self, run, ids, B, c, layout, starts, cnts, K, J, t_i,
                    progress):
        """Run the blocks `ids` through one mapper in batches of B; scatter
        the resolved ones and return (far-only, capacity) overflow ids."""
        stats = self.stats
        still_far: list[np.ndarray] = []
        still_cap: list[np.ndarray] = []
        for s in range(0, len(ids), B):
            sel = ids[s : s + B]
            t0 = time.perf_counter()
            out = self._run_batch(run, layout, starts[sel], cnts[sel], B)
            t1 = time.perf_counter()
            hits = out["hits"].cpu().numpy()
            ovf = out["overflow"].cpu().numpy()[: len(sel)]
            ovfc = out["overflow_cap"].cpu().numpy()[: len(sel)]
            t2 = time.perf_counter()
            self._scatter_batch(c, hits, starts[sel], cnts[sel], ~ovf)
            stats["dispatch_s"] += t1 - t0
            stats["fetch_s"] += t2 - t1
            stats["scatter_s"] += time.perf_counter() - t2
            stats["batches"] += 1
            stats["overflow_blocks"] += int(ovf.sum())
            stats["max_tier"] = max(stats["max_tier"], t_i)
            tb = stats["tier_blocks"]
            tb[t_i] = tb.get(t_i, 0) + len(sel)
            still_cap.append(sel[ovfc])
            still_far.append(sel[ovf & ~ovfc])
            if progress is not None:
                progress.add(len(sel))
        cat = lambda xs: np.concatenate(xs) if xs else np.empty(0, np.int64)  # noqa: E731
        return cat(still_far), cat(still_cap)

    def _run_batch(self, run, layout, bstarts, bcnts, B):
        nb = len(bstarts)
        pad_b = B - nb
        starts = np.concatenate([bstarts, np.zeros(pad_b, np.int64)])
        cnts = np.concatenate([bcnts, np.zeros(pad_b, np.int32)]).astype(np.int32)
        # global base positions; needle windows are extracted on the device
        # from the packed text, so a batch ships only these starts
        gstarts = (layout.start + starts).astype(np.uint32).view(np.int32)
        limit = layout.start + layout.length
        dev = self.device
        return run(torch.from_numpy(gstarts).to(dev),
                   torch.from_numpy(cnts).to(dev), limit)

    @staticmethod
    def _scatter_batch(c, hits, bstarts, bcnts, ok):
        for b in np.nonzero(ok)[0]:
            i0 = int(bstarts[b])
            cnt = int(bcnts[b])
            c[i0 : i0 + cnt] = hits[b, :cnt]
