"""Host orchestrator: per-file (k,e)-frequency computation on the device.

Port of `genmap_tpu/engine/mappability.py` on one device, for single- and
multi-part indexes: block decomposition of a file (or of a BED selection),
the unique-infix probe, same-k-mer dedup, the batch loop over the block
mapper (search/engine.py, one mapper per index part, counts summed over the
parts), the dimer-table policy (tier 0 and twins of the wide tiers on the
dimer rows), capacity-tier escalation routed by overflow kind, a rescue
pass at the static largest tier, scatter into the frequency vector, the CSV
location table, the exclude-pseudo reduction and resetLimits.  Occupancy
calibration and the split pipeline are not part of this port yet; neither
changes a result.

Capability map to the reference (GenMap src/):
  - per-file segmentation loop            mappability.hpp:276-365
  - block decomposition + compute         algo.hpp:405-483
  - resetLimits boundary zeroing          algo.hpp:10-22
  - CSV location collection               algo.hpp:311-386
  - exclude-pseudo distinct-file count    algo.hpp:351-364
  - same-k-mer duplicate sharing          algo.hpp:236-242, 389-396
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from genmap_tpu_torch.index.fmindex import FMIndexData
from genmap_tpu_torch.ops.rank import DeviceIndex, DeviceText, locate, resolve_device
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
    exclude_pseudo: bool = False


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
    locations: dict  # {(i1,i2): (fwd_locs, rc_locs)} with per-file keys
    layout: FileLayout


def _u32(t: torch.Tensor) -> np.ndarray:
    """Host copy of an int32 tensor that holds uint32 bits."""
    return t.cpu().numpy().view(np.uint32)


class MappabilityEngine:
    """Single-device mapping engine.

    Runs on `device` ("cuda" by default; "cpu" takes every kernel's plain
    PyTorch version); raises on "cuda" without a card.  Every part of a
    multi-part index stays resident on the device and is searched in turn;
    matches never span parts, so per-part counts add up.  `light=True`
    leaves the SA samples off the device: only `locate` (CSV,
    exclude-pseudo) reads them.

    `dimer_tier`: None (auto) runs tier 0 on the dimer rows for
    configurations whose static pool schedule is wide (mean >= 12 slots) and
    inserts a dimer twin before every wide exact tier, when every part has
    dimer rows with a flagged sub-block fraction below 1e-3 and the ladder is
    DEFAULT_TIERS; True forces both wherever every part has dimer rows;
    False never uses them.  These gates are the JAX package's own; the
    dimer rows change speed only, never a result."""

    def __init__(
        self,
        data: FMIndexData,
        batch_blocks: int = 256,
        tiers: tuple[Tier, ...] = DEFAULT_TIERS,
        batch_kmers: int = 0,
        dedup: bool = True,
        light: bool = False,
        device="cuda",
        dimer_tier: bool | None = None,
    ):
        self.device = resolve_device(device)
        self.data = data
        self.batch_blocks = batch_blocks
        self.batch_kmers = batch_kmers
        self.dedup = dedup
        self.light = light
        self.tiers = tuple(tiers)
        self.dtext = DeviceText.from_host(data, self.device)
        self.indices = [DeviceIndex.from_part(data, p, light=light, device=self.device)
                        for p in data.parts]
        self.layouts = file_layouts(data)
        # dimer-tier policy (see the class docstring); the auto gate's
        # thresholds were set on a TPU and are kept so that the tier routing
        # equals the JAX engine's
        self._dimer_mode = dimer_tier
        self._dimer_ok = tiers is DEFAULT_TIERS and all(
            p.dimer is not None and p.dimer_flag_frac < 1e-3 for p in data.parts
        )
        self._dimer_forced_ok = all(p.dimer is not None for p in data.parts)
        self._text = None
        self._runners: dict = {}
        # unique-infix probe (see _execute_blocks); off for A-B comparisons
        self._probe_enabled = True
        # probe scan cut: stop at log4(2n) + slack chars (None = full scan)
        self._probe_cut_slack = 14
        # SA rows per locate launch (the plain CPU path walks all rows of a
        # chunk at once, so it takes smaller chunks)
        self._locate_chunk = (1 << 20) if self.device.type == "cuda" else (1 << 14)
        self._dup_rate_cache: dict = {}
        # per-compute overflow/tier statistics + phase timers (device time
        # lands in fetch_s: the result copy waits for the device)
        self.stats = {
            "overflow_blocks": 0, "max_tier": 0, "batches": 0,
            "dispatch_s": 0.0, "fetch_s": 0.0, "scatter_s": 0.0,
            "dimer_tier": False, "probe_skipped": 0,
            "tier_blocks": {},  # blocks PROCESSED per tier index
            "tiers": (),  # the ladder of the last compute, twins included
        }
        # global sequence id -> file ordinal, for exclude-pseudo
        self.seq_file_id = np.zeros(data.nseq, dtype=np.int64)
        fid = 0
        for k in range(1, data.nseq):
            if data.seq_files[k] != data.seq_files[k - 1]:
                fid += 1
            self.seq_file_id[k] = fid
        self.n_files = fid + 1

    @property
    def text(self) -> np.ndarray:
        """Host-decoded concatenated text, materialized on first use (needle
        windows are extracted on the device from the packed text; only the
        dedup key pass reads host text, one file's slice at a time)."""
        if self._text is None:
            self._text = self.data.decode_text()
        return self._text

    def resident_bytes(self) -> int:
        """Bytes of index parts and text held on the device."""
        return (sum(ix.resident_bytes() for ix in self.indices)
                + self.dtext.resident_bytes())

    def _runner(self, pi, K, errors, o, J, B, tier, cap, rev_compl,
                with_states=False, with_exact=False, probe=False,
                probe_cut=None) -> BlockMapper:
        key = (pi, K, errors, o, J, B, tier, cap, rev_compl, with_states,
               with_exact, probe, probe_cut)
        if key not in self._runners:
            self._runners[key] = BlockMapper(
                self.indices[pi], self.dtext, K=K, errors=errors, overlap=o,
                J=J, B=B, tier=tier, cap=cap, rev_compl=rev_compl,
                with_states=with_states, with_exact=with_exact, probe=probe,
                probe_cut=probe_cut,
            )
        return self._runners[key]

    def _runners_for(self, *args, **kw) -> list[BlockMapper]:
        """One batch mapper per index part (arguments of `_runner`)."""
        return [self._runner(pi, *args, **kw) for pi in range(len(self.indices))]

    def _map_seq_ids(self, pi: int, i1: np.ndarray) -> np.ndarray:
        """Map part-local sequence ids to global ids (rc half after all fwd)."""
        part = self.data.parts[pi]
        np_, off = part.nseq_part, part.seq_off
        i1 = i1.astype(np.int64)
        return np.where(i1 < np_, off + i1, self.data.nseq + off + (i1 - np_))

    def locate_many(self, pi: int,
                    positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Resolve SA rows of part `pi` to GLOBAL (seq_no, seq_pos), chunked
        on the device."""
        if self.light:
            raise RuntimeError(
                "locate is unavailable on a light engine (SA samples were not "
                "uploaded); construct MappabilityEngine(light=False) for "
                "CSV/exclude-pseudo runs"
            )
        n = len(positions)
        i1 = np.empty(n, dtype=np.uint32)
        i2 = np.empty(n, dtype=np.uint32)
        ch = self._locate_chunk
        dev = self.device
        for s in range(0, n, ch):
            part = np.ascontiguousarray(positions[s : s + ch], dtype=np.uint32)
            pos = torch.from_numpy(part.view(np.int32)).to(dev)
            valid = torch.ones(len(part), dtype=torch.uint8, device=dev)
            r1, r2 = locate(self.indices[pi], pos, valid)
            i1[s : s + len(part)] = _u32(r1)
            i2[s : s + len(part)] = _u32(r2)
        return self._map_seq_ids(pi, i1), i2

    # ------------------------------------------------------------------

    def compute_file(
        self,
        layout: FileLayout,
        params: SearchParams,
        errors: int,
        cap: int,
        intervals: list[tuple[int, int]] | None = None,
        csv: bool = False,
        file_no: int = 1,
        total_files: int = 1,
    ) -> FileResult:
        """Compute the frequency vector (and CSV locations) for one file.

        `intervals` are cumulative [begin, end) position ranges within the
        file (BED selection, mappability.hpp:276-365); None = whole file.
        """
        K = params.length
        o = params.overlap
        J = K - o + 1
        L = layout.length
        c = np.zeros(L, dtype=np.uint32)
        locations: dict = {}
        csv_needed = csv or params.exclude_pseudo

        nkmers = L - K + 1
        if nkmers <= 0:
            return FileResult(c=c, locations=locations, layout=layout)

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
            return FileResult(c=c, locations=locations, layout=layout)

        progress = Progress(len(starts), file_no, total_files)
        done = False
        if self.dedup and intervals is None and not csv_needed and nkmers >= 8192:
            # the dedup key pass is the only host-side reader of the text
            text = self.data.decode_slice(layout.start, L)
            done = self._compute_with_dedup(
                text, c, locations, layout, starts, cnts, K, o, J, errors,
                cap, params, progress, nkmers,
            )
        if not done:
            self._execute_blocks(c, locations, layout, starts, cnts, K, o, J,
                                 errors, cap, params, csv_needed, csv, progress)
        progress.finish()
        reset_limits(c, K, layout.cum_lens)
        return FileResult(c=c, locations=locations, layout=layout)

    # ------------------------------------------------------------------

    def _execute_blocks(self, c, locations, layout, starts, cnts, K, o, J,
                        errors, cap, params, csv_needed, csv, progress=None,
                        collect_exact=None):
        """Run the probe and the tier-escalating batch loop over the blocks.

        `collect_exact`, if given, is (E_flo, E_size) — per-part lists of
        arrays of length nkmers that receive each position's zero-error SA
        interval (the duplicate-class key of the dedup pass).
        """
        self.stats["probe_skipped"] = 0
        self.stats["dimer_tier"] = False
        self.stats["tier_blocks"] = {}
        job = _Job(c, locations, layout, starts, cnts, K, o, J, errors, cap,
                   params, csv_needed, csv, collect_exact)
        plans = plans_for(errors, o)
        # pool schedules of the cost model and the dimer gates are those of
        # the largest part (each part's mapper sizes its own pools)
        n_max = max(p.n_total for p in self.data.parts)
        B0 = max(self.batch_blocks, -(-self.batch_kmers // J))
        levels = max(1, math.ceil(math.log2(max(2, J))))

        def pools_at(tier, scale=None):
            return infix_pool_schedule(plans, K - o, n_max,
                                       tier.f_search / 4.0 if scale is None else scale)

        def block_cost(tier):
            """(time_cost, peak_slots) per block at this tier: time ~ the
            state slots stepped (pool sizes plus extension steps, halved on
            a dimer tier: two chars per row read), memory ~ the widest live
            state tensor."""
            pools = pools_at(tier)
            cost = int(pools.sum()) + J * levels * tier.f_extend
            if tier.dimer:
                cost //= 2
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

        # dimer rows: tier 0 for wide-frontier configurations (the dimer
        # step's fixed cost amortizes over wide pools only), and a dimer
        # twin before every wide exact tier; far flags of a twin fall
        # through to its mono tier, capacity overflows route past it (its
        # capacities equal the mono tier's)
        forced = self._dimer_mode is True and self._dimer_forced_ok
        auto = self._dimer_mode is None and self._dimer_ok
        use_dimer = forced or (
            auto and float(pools_at(tiers[0], 1.0).mean()) >= 12.0
        )
        if use_dimer and not tiers[0].dimer:
            tiers[0] = dataclasses.replace(tiers[0], dimer=True)
        self.stats["dimer_tier"] = use_dimer
        if forced or auto:
            expanded = tiers[:1]
            for t in tiers[1:]:
                if t.exact and not t.dimer and float(pools_at(t).mean()) >= 12.0:
                    expanded.append(dataclasses.replace(t, dimer=True))
                expanded.append(t)
            tiers = expanded

        pending = np.arange(len(starts), dtype=np.int64)
        start_tier = 0  # probe residuals start at the first exact mono tier

        # ---- unique-infix short-circuit probe ---------------------------
        # If a block's infix survivor mass is 1, the only candidate
        # occurrence of every one of its k-mers is the self-match, so all J
        # frequencies are exactly 1 and the extension is skipped.  Worth it
        # when the extension costs at least half the infix scan and the
        # genome is mostly unique; the first batch's skip share decides.
        probe_ok = (
            self._probe_enabled
            and collect_exact is None
            and not csv_needed
            and J >= 2
            and len(pending) * J >= 1 << 15
        )
        if probe_ok:
            tier0 = tiers[0]
            pools0 = pools_at(tier0)
            # probe cut: mass only shrinks as chars are consumed, and past
            # ~log4(2n)+slack chars almost every undecided block is a true
            # repeat block the probe could never skip
            probe_cut = None
            if self._probe_cut_slack is not None:
                cut = math.ceil(math.log(max(2, 2 * n_max), 4)) + self._probe_cut_slack
                if len(pools0) - cut >= 6:
                    probe_cut = cut
            eff = pools0 if probe_cut is None else pools0[:probe_cut]
            halve = 2 if tier0.dimer else 1
            infix_cost = int(eff.sum()) // halve
            probe_ok = (J * levels * tier0.f_extend) // halve >= 0.5 * max(1, infix_cost)
        if probe_ok:
            # the probe's per-block cost is a fraction of the full
            # program's, so its batches may exceed the caller's block budget
            Bp = max(32, min(8 * B0, WORK // max(1, infix_cost),
                             SLOTS // max(1, int(eff.max()))))
            pending, abandoned = self._probe(job, pending, tier0, probe_cut, Bp,
                                             progress)
            if not abandoned:
                # probe residuals are repeat-context blocks: ~all of them
                # far-flag the fast tier, and all carry survivor mass >= 2,
                # so they start at the first exact mono tier with a 4-slot,
                # fast-rank extension frontier (its intervals are bounded by
                # the survivor mass and fit the one-row window)
                for j in range(1, len(tiers)):
                    if tiers[j].exact and not tiers[j].dimer:
                        start_tier = j
                        tiers[j] = dataclasses.replace(
                            tiers[j], f_extend=max(4, tiers[j].f_extend),
                            ext_exact=False,
                        )
                        break
        self.stats["tiers"] = tuple(tiers)

        # tier routing: capacity-overflow blocks skip ahead to the next tier
        # whose capacities are actually LARGER than the program they just
        # overflowed; far-only blocks (fast-rank window misses, flagged
        # dimer sub-blocks) go to the next tier, whose same-capacity exact
        # (or mono) program suffices for them
        def tier_caps(i):
            return (int(pools_at(tiers[i]).sum()), tiers[i].f_extend,
                    tiers[i].f_collect)

        caps_by_tier = [tier_caps(i) for i in range(len(tiers))]

        def next_cap_tier(i):
            for j in range(i + 1, len(tiers)):
                if any(a > b for a, b in zip(caps_by_tier[j], caps_by_tier[i])):
                    return j
            return None

        def tier_B(t_j, npend):
            cost, peak = block_cost(tiers[t_j])
            B = max(8, min(B0, WORK // max(1, cost), SLOTS // max(1, peak)))
            if t_j == start_tier:
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
        pending_at[start_tier] = pending
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
            far_blocks, cap_blocks = self._run_blocks(
                job, tier, pending, B, t_i,
                progress if t_i == start_tier else None,
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
            # the static largest tier of this engine's ladder before we fail
            # (the static ladder's own last tier, whatever twins the
            # expanded ladder holds).
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
                still += self._run_blocks(job, pristine, ids, B, last, None)
            n_still = sum(len(a) for a in still)
            if n_still:
                raise RuntimeError(
                    f"{n_still} blocks overflowed the largest frontier tier"
                )

    def _probe(self, job, pending, tier0, probe_cut, Bp, progress):
        """Probe `pending` in batches of Bp at tier0: skipped blocks get
        frequency 1 written; returns (residual block ids, abandoned).  After
        the first batch, a skip share below 0.3 abandons the probe (a repeat
        heavy genome or configuration would pay a second infix pass for
        most blocks); the remaining blocks all become residual.  On a
        multi-part index every part's mapper runs the batch and the masses
        are summed on the device before the last part decides."""
        stats = self.stats
        runs = self._runners_for(job.K, job.errors, job.o, job.J, Bp, tier0,
                                 job.cap, job.params.rev_compl, probe=True,
                                 probe_cut=probe_cut)
        residual: list[np.ndarray] = []
        abandoned = False
        skipped = 0
        J = job.J
        for s in range(0, len(pending), Bp):
            sel = pending[s : s + Bp]
            if abandoned:
                residual.append(sel)
                continue
            t0 = time.perf_counter()
            out = self._run_batch(runs, job.layout, job.starts[sel], job.cnts[sel], Bp)
            t1 = time.perf_counter()
            skip = out["skip"].cpu().numpy()[: len(sel)].astype(bool)
            t2 = time.perf_counter()
            # vectorized frequency-1 writes
            idx = np.nonzero(skip)[0]
            bst = job.starts[sel[idx]]
            bcn = job.cnts[sel[idx]]
            full = bcn == J
            if full.any():
                job.c[(bst[full][:, None] + np.arange(J)).ravel()] = 1
            for s0, cn in zip(bst[~full], bcn[~full]):
                job.c[int(s0) : int(s0) + int(cn)] = 1
            residual.append(sel[~skip])
            skipped += len(idx)
            stats["dispatch_s"] += t1 - t0
            stats["fetch_s"] += t2 - t1
            stats["scatter_s"] += time.perf_counter() - t2
            stats["batches"] += 1
            if progress is not None:
                progress.add(len(idx))
            if s == 0 and skip.mean() < 0.3:
                abandoned = True
        stats["probe_skipped"] = skipped
        pending = np.concatenate(residual) if residual else np.empty(0, np.int64)
        return pending, abandoned

    def _run_blocks(self, job, tier, ids, B, t_i, progress):
        """Run the blocks `ids` at one tier in batches of B; scatter the
        resolved ones (frequencies summed over the parts, CSV locations,
        zero-error keys per part) and return (far-only, capacity) overflow
        ids (ORed over the parts)."""
        stats = self.stats
        runs = self._runners_for(job.K, job.errors, job.o, job.J, B, tier,
                                 job.cap, job.params.rev_compl,
                                 with_states=job.csv_needed,
                                 with_exact=job.collect_exact is not None)
        still_far: list[np.ndarray] = []
        still_cap: list[np.ndarray] = []
        for s in range(0, len(ids), B):
            sel = ids[s : s + B]
            nb = len(sel)
            t0 = time.perf_counter()
            outs = self._run_batch(runs, job.layout, job.starts[sel], job.cnts[sel], B)
            t1 = time.perf_counter()
            outs = [{k: (tuple(x.cpu().numpy() for x in v) if isinstance(v, tuple)
                         else v.cpu().numpy())
                     for k, v in out.items()}
                    for out in outs]
            t2 = time.perf_counter()
            ovf = np.zeros(nb, bool)
            ovfc = np.zeros(nb, bool)
            for res in outs:
                ovf |= res["overflow"][:nb]
                ovfc |= res["overflow_cap"][:nb]
                for k in ("exact_size", "exact_size_total", "exact_flo"):
                    if k in res:
                        res[k] = res[k].view(np.uint32)
            bstarts, bcnts = job.starts[sel], job.cnts[sel]
            self._scatter_batch(job.c, [res["hits"] for res in outs], job.cap,
                                bstarts, bcnts, ~ovf)
            if job.csv_needed:
                per_part = []
                for res in outs:
                    flo, size, err, valid = res["states"]
                    per_part.append((res["exact_size_total"], res["exact_flo"],
                                     (flo.view(np.uint32), size.view(np.uint32),
                                      err, valid.astype(bool))))
                exact_size = sum(res["exact_size"].astype(np.int64) for res in outs)
                self._csv_batch(
                    job.c, job.locations, bstarts, bcnts, ~ovf, per_part,
                    exact_size, job.layout, job.params, job.K, job.errors,
                    job.cap, job.csv,
                )
            if job.collect_exact is not None:
                E_flo, E_size = job.collect_exact
                for pi, res in enumerate(outs):
                    for bi in np.nonzero(~ovf)[0]:
                        s0 = int(bstarts[bi])
                        cnt = int(bcnts[bi])
                        E_flo[pi][s0 : s0 + cnt] = res["exact_flo"][bi, :cnt]
                        E_size[pi][s0 : s0 + cnt] = res["exact_size_total"][bi, :cnt]
            stats["dispatch_s"] += t1 - t0
            stats["fetch_s"] += t2 - t1
            stats["scatter_s"] += time.perf_counter() - t2
            stats["batches"] += 1
            stats["overflow_blocks"] += int(ovf.sum())
            stats["max_tier"] = max(stats["max_tier"], t_i)
            tb = stats["tier_blocks"]
            tb[t_i] = tb.get(t_i, 0) + nb
            still_cap.append(sel[ovfc])
            still_far.append(sel[ovf & ~ovfc])
            if progress is not None:
                progress.add(nb)
        cat = lambda xs: np.concatenate(xs) if xs else np.empty(0, np.int64)  # noqa: E731
        return cat(still_far), cat(still_cap)

    def _run_batch(self, runs, layout, bstarts, bcnts, B):
        """Run one batch through every part's mapper.  Returns the list of
        their outputs; for a probe, the last part's output (its skip
        decision covers every part: the earlier parts' masses ride along in
        the accumulator)."""
        nb = len(bstarts)
        pad_b = B - nb
        starts = np.concatenate([bstarts, np.zeros(pad_b, np.int64)])
        cnts = np.concatenate([bcnts, np.zeros(pad_b, np.int32)]).astype(np.int32)
        # global base positions; needle windows are extracted on the device
        # from the packed text, so a batch ships only these starts
        gstarts = (layout.start + starts).astype(np.uint32).view(np.int32)
        limit = layout.start + layout.length
        dev = self.device
        st = torch.from_numpy(gstarts).to(dev)
        ct = torch.from_numpy(cnts).to(dev)
        if not runs[0].probe:
            return [run(st, ct, limit) for run in runs]
        acc = None
        for run in runs[:-1]:
            acc = run(st, ct, limit, acc=acc, last=False)["acc"]
        return runs[-1](st, ct, limit, acc=acc)

    @staticmethod
    def _scatter_batch(c, hits_parts, cap, bstarts, bcnts, ok):
        """Write the resolved blocks' frequencies: per-part counts add up
        exactly (matches never span parts), clamped to cap."""
        hits = np.zeros(hits_parts[0].shape, np.uint32)
        for h in hits_parts:
            hits += h
        np.minimum(hits, np.uint32(cap), out=hits)
        for b in np.nonzero(ok)[0]:
            i0 = int(bstarts[b])
            cnt = int(bcnts[b])
            c[i0 : i0 + cnt] = hits[b, :cnt]

    # ------------------------------------------------------------------

    def _compute_with_dedup(
        self, text, c, locations, layout, starts, cnts, K, o, J, errors, cap,
        params, progress, nkmers,
    ) -> bool:
        """Exact-duplicate k-mer sharing (reference trick algo.hpp:236-242,
        389-396): class every k-mer by its exact string identity, run the
        search only on blocks containing a class's first occurrence, and
        copy class results to all duplicate positions.

        Class keys: the packed k-mer value (K <= 27) or — for larger K when a
        sample says duplicates are frequent — the zero-error SA interval
        (flo, size) of every index part from a cheap e=0 pre-pass, which
        uniquely identifies the k-mer string among k-mers that match
        themselves.  Returns False
        when dedup is not worthwhile (the caller runs normally).
        """
        if K <= 27 and nkmers <= (1 << 31):
            # cheap sampled gate first: full key building + np.unique over
            # all k-mers costs seconds at genome scale
            if nkmers > (1 << 21) and self._dup_rate(layout, text, K, nkmers) < 0.15:
                return False
            keys = np.zeros(nkmers, dtype=np.uint64)
            for i in range(K):
                keys *= np.uint64(5)
                keys += text[i : i + nkmers]
            classes, inverse = np.unique(keys, return_inverse=True)
            del keys
        else:
            if errors == 0:
                return False  # the e=0 pre-pass would equal the main pass
            if self._dup_rate(layout, text, K, nkmers) < 0.3:
                return False
            P = len(self.data.parts)
            E_flo = [np.zeros(nkmers, np.uint32) for _ in range(P)]
            E_size = [np.zeros(nkmers, np.uint32) for _ in range(P)]
            self._execute_blocks(
                np.zeros_like(c), {}, layout, starts, cnts, K, o, J, 0, cap,
                params, False, False, collect_exact=(E_flo, E_size),
            )
            # one (flo, size) column pair per part
            key_arr = np.zeros((nkmers, 2 * P + 1), dtype=np.uint32)
            tot = np.zeros(nkmers, np.uint64)
            for pi in range(P):
                key_arr[:, 2 * pi] = E_flo[pi]
                key_arr[:, 2 * pi + 1] = E_size[pi]
                tot += E_size[pi]
            # k-mers that match nothing (they contain N: N matches nothing,
            # not even N) are NOT identified by their interval; give each its
            # own class via the extra column
            nomatch = tot == 0
            key_arr[nomatch, 2 * P] = np.arange(1, int(nomatch.sum()) + 1, dtype=np.uint32)
            void = np.ascontiguousarray(key_arr).view(
                np.dtype((np.void, key_arr.shape[1] * 4))
            ).ravel()
            classes, inverse = np.unique(void, return_inverse=True)
            del key_arr, void

        # first occurrence of each class (reversed write: first position wins)
        first_occ = np.empty(len(classes), dtype=np.int64)
        first_occ[inverse[::-1]] = np.arange(nkmers - 1, -1, -1)
        keep = np.unique(first_occ // J)
        if len(keep) > 0.85 * len(starts):
            return False  # few duplicates: per-class bookkeeping not worth it

        self._execute_blocks(
            c, locations, layout, starts[keep], cnts[keep], K, o, J,
            errors, cap, params, False, False, progress=None,
        )
        if progress is not None:
            progress.add(len(starts))
        # copy class results to every duplicate position
        c[:nkmers] = c[first_occ[inverse]]
        return True

    def _dup_rate(self, layout, text, K, nkmers) -> float:
        key = (layout.start, layout.length, K)
        if key not in self._dup_rate_cache:
            self._dup_rate_cache[key] = self._sampled_dup_rate(text, K, nkmers)
        return self._dup_rate_cache[key]

    @staticmethod
    def _sampled_dup_rate(text, K, nkmers, sample=1 << 19) -> float:
        rng = np.random.default_rng(12345)
        s = min(sample, nkmers)
        pos = rng.integers(0, nkmers, size=s)
        win = text[pos[:, None] + np.arange(K)[None, :]]
        nuniq = len(np.unique(np.ascontiguousarray(win).view(
            np.dtype((np.void, K))).ravel()))
        return 1.0 - nuniq / s

    # ------------------------------------------------------------------

    def _split_strand(self, i1, i2, K):
        """Split located rows into per-strand lists with rc mapped back.

        A row in the rc half (i1 >= nseq) at position p in rc(seq s) is an
        occurrence of rc(pattern) in seq s at len_s - K - p.
        """
        nseq = self.data.nseq
        is_rc = i1 >= nseq
        p1, p2 = i1[~is_rc].astype(np.int64), i2[~is_rc].astype(np.int64)
        m1 = (i1[is_rc] - nseq).astype(np.int64)
        m2 = (
            self.data.seq_lens[m1].astype(np.int64) - K - i2[is_rc].astype(np.int64)
        )
        o = np.lexsort((p2, p1))
        om = np.lexsort((m2, m1))
        return (p1[o], p2[o]), (m1[om], m2[om])

    def _csv_batch(
        self, c, locations, bstarts, bcnts, ok, per_part, exact_size,
        layout, params, K, errors, cap, csv_out,
    ):
        """CSV location lists + exclude-pseudo (algo.hpp:311-400).

        `per_part` is a list of (exact_size_total, exact_flo, states) per
        index part; each part's rows are located against that part and
        mapped to global sequence ids, then all rows are grouped per k-mer
        by one global lexsort over (k-mer, kind, strand), with per-key work
        reduced to array-view slicing.
        """
        nb = len(bstarts)
        J = per_part[0][2][1].shape[1] if per_part else 0
        jmask = (np.arange(J)[None, :] < np.asarray(bcnts)[:, None]) & np.asarray(ok)[:, None]
        kb_l, kj_l, kk_l, i1_l, i2_l = [], [], [], [], []
        for pi, (exact_size_total, exact_flo, states) in enumerate(per_part):
            flo, size, err, valid = states
            # "all" rows: every valid state's interval; "exact" rows: the
            # zero-error interval of k-mers with more than one forward
            # occurrence (their key placement)
            vm = valid[:nb] & (size[:nb] > 0) & jmask[:, :, None]
            bs, js, fs = np.nonzero(vm)
            szs = size[:nb][bs, js, fs].astype(np.int64)
            flos = flo[:nb][bs, js, fs].astype(np.int64)

            em = jmask & (exact_size[:nb] > 1) & (exact_size_total[:nb] > 0)
            ebs, ejs = np.nonzero(em)
            eszs = exact_size_total[:nb][ebs, ejs].astype(np.int64)
            eflos = exact_flo[:nb][ebs, ejs].astype(np.int64)

            all_sizes = np.concatenate([szs, eszs])
            all_flos = np.concatenate([flos, eflos])
            if len(all_sizes) == 0:
                continue
            total = int(all_sizes.sum())
            offs = np.zeros(len(all_sizes), np.int64)
            np.cumsum(all_sizes[:-1], out=offs[1:])
            all_rows = np.repeat(all_flos - offs, all_sizes) + np.arange(total)
            i1, i2 = self.locate_many(pi, all_rows)

            kb_l.append(np.repeat(np.concatenate([bs, ebs]), all_sizes))
            kj_l.append(np.repeat(np.concatenate([js, ejs]), all_sizes))
            kk_l.append(np.repeat(
                np.concatenate([np.zeros(len(bs), np.int8),
                                np.ones(len(ebs), np.int8)]),
                all_sizes,
            ))
            i1_l.append(i1.astype(np.int64))
            i2_l.append(i2.astype(np.int64))
        if not kb_l:
            return
        kb = np.concatenate(kb_l)
        kj = np.concatenate(kj_l)
        kk = np.concatenate(kk_l)
        g1 = np.concatenate(i1_l)
        g2 = np.concatenate(i2_l)

        nseq = self.data.nseq
        directory = self.data.directory
        seq_lens = self.data.seq_lens.astype(np.int64)
        # strand split + rc coordinate mapping: a row in the rc half
        # (i1 >= nseq) at position p in rc(seq s) is an occurrence of
        # rc(pattern) in seq s at len_s - K - p
        is_rc = g1 >= nseq
        a1 = np.where(is_rc, g1 - nseq, g1)
        a2 = np.where(is_rc, seq_lens[a1] - K - g2, g2)
        # group rows by (b, j, kind, strand), position-sorted within
        order = np.lexsort((a2, a1, is_rc, kk, kj, kb))
        kb, kj, kk, a1, a2, is_rc = (
            x[order] for x in (kb, kj, kk, a1, a2, is_rc)
        )
        # segment boundaries of the (b, j) groups
        key_bj = kb.astype(np.int64) * (J + 1) + kj
        bj_bounds = np.flatnonzero(np.diff(key_bj)) + 1
        bj_starts = np.concatenate([[0], bj_bounds])
        bj_ends = np.concatenate([bj_bounds, [len(kb)]])

        if params.exclude_pseudo:
            # distinct FILES per k-mer over both strands ("all" rows only;
            # rc occurrences only count under -r/rev_compl)
            allm = (kk == 0) & (params.rev_compl | ~is_rc)
            bj_ids = np.cumsum(
                np.concatenate([[0], np.diff(key_bj) != 0])
            )  # dense group ordinal per row
            fkey = (
                bj_ids[allm] * np.int64(self.n_files)
                + self.seq_file_id[a1[allm]]
            )
            ubj = np.unique(fkey) // self.n_files
            cnts_f = np.bincount(ubj, minlength=int(bj_ids.max()) + 1 if len(bj_ids) else 0)
            for s0 in bj_starts:
                b, j = int(kb[s0]), int(kj[s0])
                p = int(bstarts[b]) + j
                gid = int(bj_ids[s0])
                nf = int(cnts_f[gid]) if gid < len(cnts_f) else 0
                c[p] = min(nf, cap)

        if not csv_out:
            return

        empty = np.empty(0, np.int64)
        for s0, e0 in zip(bj_starts, bj_ends):
            b, j = int(kb[s0]), int(kj[s0])
            p = int(bstarts[b]) + j
            seg = slice(s0, e0)
            ks, rs = kk[seg], is_rc[seg]
            s_a1, s_a2 = a1[seg], a2[seg]
            am = ks == 0
            fm = am & ~rs
            rm = am & rs
            f1, f2 = s_a1[fm], s_a2[fm]
            if params.rev_compl:
                r1, r2 = s_a1[rm], s_a2[rm]
            else:
                r1, r2 = empty, empty
            entry = ((f1, f2), (r1, r2))

            if not directory and int(exact_size[b, j]) > 1:
                em_ = (ks == 1) & ~rs  # key placement: fwd exact occurrences
                q1s, q2s = s_a1[em_], s_a2[em_]
                okq = q2s <= seq_lens[q1s] - K
                for q1, q2 in zip(q1s[okq], q2s[okq]):
                    locations[(int(q1), int(q2))] = entry
            elif len(f1) + (len(r1) if params.rev_compl else 0) > 0:
                # localize p within this file's chromosomes
                s = int(np.searchsorted(layout.cum_lens, p, side="right") - 1)
                i2p = p - int(layout.cum_lens[s])
                if i2p <= int(layout.chrom_lens[s]) - K:
                    locations[(s, i2p)] = entry


@dataclass
class _Job:
    """One `_execute_blocks` call: the blocks, their configuration and
    where the results go."""

    c: np.ndarray
    locations: dict
    layout: FileLayout
    starts: np.ndarray
    cnts: np.ndarray
    K: int
    o: int
    J: int
    errors: int
    cap: int
    params: SearchParams
    csv_needed: bool
    csv: bool
    collect_exact: tuple | None
