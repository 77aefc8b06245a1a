"""Host orchestrator: per-file (k,e)-frequency computation on the device.

Port of `genmap_tpu/engine/mappability.py`, for single- and multi-part
indexes, on one device or on a mesh of ranks (parallel/): block
decomposition of a file (or of a BED selection), the unique-infix probe,
same-k-mer dedup, occupancy calibration of each tier's cohort (per index
part), the batch loop over the block mapper (search/engine.py, one mapper
per index part, counts summed over the parts; on a part mesh one mapper
whose counts merge over the ranks) or, for single-part plain-counting
maps on one device with J >= 16, the split
pipeline (phase-A infix collectors, phase-B extenders per survivor rung
with the fast-dimer -> exact-dimer -> exact-mono mode ladder), the
dimer-table policy (tier 0 and twins of the wide tiers on the dimer rows),
capacity-tier escalation routed by overflow kind, a rescue pass at the
static largest tier, scatter into the frequency vector, the CSV location
table, the exclude-pseudo reduction and resetLimits.  Calibration and the
split pipeline change speed only, never a result; their gates, constants
and dispatch order are the JAX engine's, so the blocks per tier, the
calibrated pools and the extension schedules equal its.

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
from dataclasses import dataclass

import numpy as np
import torch

from genmap_tpu_torch import tracing
from genmap_tpu_torch.index.fmindex import FMIndexData
from genmap_tpu_torch.ops.rank import DeviceText, locate, resolve_device
from genmap_tpu_torch.parallel.mesh import replicate_index
from genmap_tpu_torch.progress import Progress
from genmap_tpu_torch.search.engine import (
    DEFAULT_TIERS,
    BlockMapper,
    Extender,
    Tier,
    _quant4,
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
    """The mapping engine.

    Runs on `device` ("cuda" by default; "cpu" takes every kernel's plain
    PyTorch version); raises on "cuda" without a card.  Every part of a
    multi-part index stays resident on the device and is searched in turn;
    matches never span parts, so per-part counts add up.  `light=True`
    leaves the SA samples off the device: only `locate` (CSV,
    exclude-pseudo) reads them.

    `mesh` (parallel/mesh.py, every rank of the world constructing its
    engine alike): a data mesh keeps every part on every rank and splits
    each batch's blocks over the ranks; a part x data mesh
    (parallel/partmesh.py) keeps one part per rank and merges per-part
    results over the part axis.  Batch sizes round up to multiples of the
    data size, the split pipeline stays off (the JAX package's gate), and
    every rank returns the same results.

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
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.data = data
        self.batch_blocks = batch_blocks
        self.batch_kmers = batch_kmers
        self.dedup = dedup
        self.light = light
        self.tiers = tuple(tiers)
        self.mesh = mesh
        self.part_sharded = mesh is not None and "part" in mesh.axis_names
        with tracing.span("engine.upload"):
            self.dtext = DeviceText.from_host(data, self.device)
            if self.part_sharded:
                from genmap_tpu_torch.parallel.partmesh import stack_parts

                self.indices = None
                self.stacked = stack_parts(data, mesh, light=light, device=self.device)
                self._part_locator = None
            else:
                self.indices = replicate_index(data, light, self.device)
        # blocks per rank: the batch splits evenly over the data axis
        self._mesh_data = 1 if mesh is None else mesh.shape["data"]
        self.batch_blocks = self._round(batch_blocks)
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
        # occupancy-calibrated pool schedules, {(K, e, o, dimer, f_extend,
        # tier): (per-part pools or "static", f_extend or None)}, kept
        # across compute calls; off for A-B comparisons and tests
        self._calibrate_enabled = True
        self._cal_batch = 2048  # calibration sample size (tests shrink it)
        self._tuned_pools: dict = {}
        # the split pipeline's measured per-level extension schedules,
        # {(K, e, o, rung, exact, dimer): tuple | "flat" | "measuring"}
        self._ext_sched: dict = {}
        # record the routes and the split pipeline's blocks per (tier, rung,
        # exact, dimer) in stats["routes"] / stats["rung_sel"] (tests)
        self._record_tier_sel = False
        # per-compute overflow/tier statistics; the phase timers and the
        # batch count are the engine.dispatch / .fetch / .scatter span
        # totals and the engine.batches counter of this engine's compute
        # calls (device time lands in fetch_s: the result copy waits for
        # the device)
        self.stats = {
            "overflow_blocks": 0, "max_tier": 0, "batches": 0,
            "dispatch_s": 0.0, "fetch_s": 0.0, "scatter_s": 0.0,
            "dimer_tier": False, "probe_skipped": 0,
            "tier_blocks": {},  # blocks PROCESSED per tier index
            "tiers": (),  # the ladder of the last compute, twins included
            "phase_a_batches": 0, "rung_batches": {}, "rung_blocks": {},
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

    def resident_indices(self) -> list:
        """The index parts held on this device."""
        return [self.stacked["index"]] if self.part_sharded else self.indices

    def resident_bytes(self) -> int:
        """Bytes of index parts and text held on the device."""
        return (sum(ix.resident_bytes() for ix in self.resident_indices())
                + self.dtext.resident_bytes())

    def _round(self, B: int) -> int:
        """B rounded up to a multiple of the mesh's data size (at least
        one block per rank)."""
        n = self._mesh_data
        return max(n, -(-B // n) * n)

    def _runner(self, pi, K, errors, o, J, B, tier, cap, rev_compl,
                with_states=False, with_exact=False, probe=False,
                probe_cut=None, pools=None, with_occ=False,
                collect_only=False) -> BlockMapper:
        key = (pi, K, errors, o, J, B, tier, cap, rev_compl, with_states,
               with_exact, probe, probe_cut, pools, with_occ, collect_only)
        if key not in self._runners:
            self._runners[key] = BlockMapper(
                self.indices[pi], self.dtext, K=K, errors=errors, overlap=o,
                J=J, B=B, tier=tier, cap=cap, rev_compl=rev_compl,
                with_states=with_states, with_exact=with_exact, probe=probe,
                probe_cut=probe_cut, pools=pools, with_occ=with_occ,
                collect_only=collect_only, mesh=self.mesh,
            )
        return self._runners[key]

    def _runners_for(self, K, errors, o, J, B, tier, cap, rev_compl, *,
                     pools_list=None, with_states=False, with_exact=False,
                     probe=False, probe_cut=None, with_occ=False) -> list[BlockMapper]:
        """One batch mapper per index part, each at its part's calibrated
        pools where `pools_list` gives them; on a part mesh ONE mapper (or
        prober) whose outputs are already merged over the parts, at the
        calibrated pools of the widest part."""
        if not self.part_sharded:
            return [self._runner(pi, K, errors, o, J, B, tier, cap, rev_compl,
                                 with_states=with_states, with_exact=with_exact,
                                 probe=probe, probe_cut=probe_cut, with_occ=with_occ,
                                 pools=None if pools_list is None else pools_list[pi])
                    for pi in range(len(self.indices))]
        from genmap_tpu_torch.parallel.partmesh import PartMapper, PartProber

        pools = None if pools_list is None else pools_list[0]
        key = ("psh", K, errors, o, J, B, tier, cap, rev_compl, with_states,
               with_exact, probe, probe_cut, pools, with_occ)
        if key not in self._runners:
            common = dict(K=K, errors=errors, overlap=o, J=J, B=B, tier=tier, cap=cap,
                          rev_compl=rev_compl)
            self._runners[key] = (
                PartProber(self.stacked, self.dtext, self.mesh, **common,
                           probe_cut=probe_cut) if probe else
                PartMapper(self.stacked, self.dtext, self.mesh, **common, pools=pools,
                           with_occ=with_occ, with_exact_parts=with_exact,
                           with_states=with_states))
        return [self._runners[key]]

    def _expand_part_outs(self, outs: list) -> list:
        """A part-mesh mapper returns ONE merged dict; expand it into the
        per-part list the CSV and dedup host code reads: per-part axes from
        the gathered *_parts outputs, merged counts on part 0 and zeros on
        the others (the consumers sum over parts)."""
        if not (self.part_sharded and "exact_flo_parts" in outs[0]):
            return outs
        out = outs[0]
        res = []
        for pi in range(len(self.data.parts)):
            d = {k: (v if pi == 0 else np.zeros_like(v)) for k, v in out.items()
                 if k in ("hits", "overflow", "overflow_cap", "exact_size")}
            d["exact_size_total"] = out["exact_size_total_parts"][:, pi]
            d["exact_flo"] = out["exact_flo_parts"][:, pi]
            if "states_parts" in out:
                d["states"] = tuple(a[:, pi] for a in out["states_parts"])
            res.append(d)
        return res

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
        if self.part_sharded:
            # LF walks on the ranks of part pi, against its own sampled SA
            from genmap_tpu_torch.parallel.partmesh import PartLocator

            if self._part_locator is None:
                self._part_locator = PartLocator(self.stacked, self.mesh)
            fn = self._part_locator
        else:
            fn = lambda p, pos, valid: locate(self.indices[p], pos, valid)  # noqa: E731
        for s in range(0, n, ch):
            part = np.ascontiguousarray(positions[s : s + ch], dtype=np.uint32)
            pos = torch.from_numpy(part.view(np.int32)).to(dev)
            valid = torch.ones(len(part), dtype=torch.uint8, device=dev)
            r1, r2 = fn(pi, pos, valid)
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

        snap = tracing.snapshot()
        progress = Progress(len(starts), file_no, total_files)
        done = False
        if self.dedup and intervals is None and not csv_needed and nkmers >= 8192:
            # the dedup key pass is the only host-side reader of the text;
            # engine.dedup's self time is that pass
            with tracing.span("engine.dedup"):
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
        added = tracing.since(snap)
        for key, name in (("dispatch_s", "engine.dispatch"), ("fetch_s", "engine.fetch"),
                          ("scatter_s", "engine.scatter")):
            self.stats[key] += added["spans"].get(name, {}).get("s", 0.0)
        self.stats["batches"] += added["counters"].get("engine.batches", 0)
        return FileResult(c=c, locations=locations, layout=layout)

    # ------------------------------------------------------------------

    @tracing.spanned("engine.blocks")
    def _execute_blocks(self, c, locations, layout, starts, cnts, K, o, J,
                        errors, cap, params, csv_needed, csv, progress=None,
                        collect_exact=None):
        """Run the probe, the occupancy calibration and the tier-escalating
        batch loop over the blocks (the split pipeline where its gate
        opens).

        `collect_exact`, if given, is (E_flo, E_size) — per-part lists of
        arrays of length nkmers that receive each position's zero-error SA
        interval (the duplicate-class key of the dedup pass).
        """
        self.stats["probe_skipped"] = 0
        self.stats["dimer_tier"] = False
        self.stats["tier_blocks"] = {}
        # the split pipeline's phase-A batches and, per (tier, rung, exact,
        # dimer), its phase-B batches and blocks
        self.stats["phase_a_batches"] = 0
        self.stats["rung_batches"] = {}
        self.stats["rung_blocks"] = {}
        if self._record_tier_sel:
            self.stats["rung_sel"] = {}
            self.stats["routes"] = []
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

        def block_cost(tier, tuned_pools=None):
            """(time_cost, peak_slots) per block at this tier: time ~ the
            state slots stepped (pool sizes, calibrated ones where given,
            plus extension steps, halved on a dimer tier: two chars per row
            read), memory ~ the widest live state tensor."""
            if tuned_pools is not None:
                psum = max(sum(p) for p in tuned_pools)
                pmax = max(max(p) for p in tuned_pools)
            else:
                pools = pools_at(tier)
                psum, pmax = int(pools.sum()), int(pools.max())
            cost = psum + J * levels * tier.f_extend
            if tier.dimer:
                cost //= 2
            peak = max(pmax, J * tier.f_extend)
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
        dimer_esc = forced or auto
        if dimer_esc:
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
            if self.mesh is not None:
                # the JAX package's rounding under a mesh (its skip-bitmap
                # words, split over the data axis), so the probe batches
                # equal its
                nsh = self._mesh_data
                Bp = max(nsh, -(-Bp // (32 * nsh)) * 32 * nsh)
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

        # calibrate the main cohort at its start tier (all blocks when no
        # probe ran; the repeat-rich residual when it did)
        cal = (job, tiers, plans, n_max, block_cost, progress)
        pending, tuned, fe0 = self._run_calibration(pending, start_tier, *cal)
        # f_extend tuning is adopted on the probe-residual path only (the
        # JAX package measured a loss for the bulk tier-0 cohort)
        if fe0 and start_tier > 0:
            tiers[start_tier] = dataclasses.replace(tiers[start_tier], f_extend=fe0)

        # tier routing: capacity-overflow blocks skip ahead to the next tier
        # whose capacities are actually LARGER than the program they just
        # overflowed (calibrated pools count); far-only blocks (fast-rank
        # window misses, flagged dimer sub-blocks) go to the next tier,
        # whose same-capacity exact (or mono) program suffices for them
        tuned_by_tier = {start_tier: tuned}

        def tier_caps(i):
            ti = tuned_by_tier.get(i)
            psum = (max(sum(p) for p in ti) if ti is not None
                    else int(pools_at(tiers[i]).sum()))
            return (psum, tiers[i].f_extend, tiers[i].f_collect)

        caps_by_tier = [tier_caps(i) for i in range(len(tiers))]

        def next_cap_tier(i):
            for j in range(i + 1, len(tiers)):
                if any(a > b for a, b in zip(caps_by_tier[j], caps_by_tier[i])):
                    return j
            return None

        def tier_B(t_j, npend, pools_over=None):
            cost, peak = block_cost(
                tiers[t_j],
                pools_over if pools_over is not None
                else (tuned if t_j == start_tier else None),
            )
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
            return self._round(B)

        # the split pipeline (phase-A infix collectors, phase-B extenders
        # per survivor rung): the JAX package's gate, copied so that the
        # routing and the stats equal its — one device, one index part,
        # plain counting, and only where the extension dominates (J >= 16)
        use_split = (
            collect_exact is None
            and not csv_needed
            and self.mesh is None
            and len(self.indices) == 1
            and J >= 16
        )
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
            if t_i == start_tier:
                tuned_i = tuned
            else:
                # escalation cohorts get their own calibration (cached per
                # configuration and tier), and the routing table follows
                # the capacities it sets
                pending, tuned_i, fe_i = self._run_calibration(pending, t_i, *cal)
                pending_at[t_i] = pending
                if fe_i and start_tier > 0:
                    tiers[t_i] = tier = dataclasses.replace(tier, f_extend=fe_i)
                tuned_by_tier[t_i] = tuned_i
                caps_by_tier[t_i] = tier_caps(t_i)
                if len(pending) == 0:
                    continue
            B = tier_B(t_i, len(pending), pools_over=tuned_i)
            with tracing.span("engine.tier"):
                if use_split:
                    far_blocks, cap_blocks, unres = self._run_tier_split(
                        job, t_i, tier, pending, B, tuned_i, start_tier, progress,
                        dimer_esc,
                    )
                    if len(unres):
                        unresolved_other.append(unres)
                else:
                    far_blocks, cap_blocks = self._run_blocks(
                        job, tier, pending, B, t_i,
                        progress if t_i == start_tier else None, pools_list=tuned_i,
                    )
            if self._record_tier_sel:
                routes = self.stats["routes"]
                if len(far_blocks):
                    routes.append((t_i, t_i + 1 if t_i + 1 < len(tiers) else None,
                                   "far", len(far_blocks)))
                if len(cap_blocks):
                    routes.append((t_i, next_cap_tier(t_i), "cap", len(cap_blocks)))
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
        self.stats["tiers"] = tuple(tiers)
        if unresolved_ran_last or unresolved_other:
            # Rescue pass: the ladder's results contract is the STATIC final
            # schedule.  Blocks that fell off the routing table before the
            # last tier, or overflowed a calibrated or modified last tier,
            # get one pass at the static largest tier of this engine's
            # ladder before we fail (the static ladder's own last tier,
            # whatever twins the expanded ladder holds).
            last = len(tiers) - 1
            pristine = self.tiers[-1]
            last_was_static = tuned_by_tier.get(last) is None and tiers[last] == pristine
            rescue = unresolved_other + (
                [] if last_was_static else unresolved_ran_last
            )
            still = list(unresolved_ran_last if last_was_static else [])
            if rescue:
                ids = np.unique(np.concatenate(rescue))
                cost, peak = block_cost(pristine)
                B = self._round(max(8, min(B0, WORK // max(1, cost),
                                           SLOTS // max(1, peak), 1024)))
                with tracing.span("engine.rescue"):
                    still += self._run_blocks(job, pristine, ids, B, last, None)
            n_still = sum(len(a) for a in still)
            if n_still:
                raise RuntimeError(
                    f"{n_still} blocks overflowed the largest frontier tier"
                )

    @tracing.spanned("engine.calibration")
    def _run_calibration(self, pending, cal_idx, job, tiers, plans, n_max,
                         block_cost, progress):
        """Occupancy calibration of the cohort `pending` at tier `cal_idx`
        (port of the JAX engine's run_calibration, line for line).

        The static pool schedule is a safe but crude estimate; a sample batch
        of the cohort runs at an 8x wider measuring tier with per-step
        candidate counts (`BlockMapper(with_occ=True)`), its resolved blocks
        are scattered, and the rest of the cohort runs at pools sized to the
        measurement (tighter or, for repeat-rich cohorts, wider), with an
        f_extend from the sample's survivor counts.  Cached per (K, e, o,
        dimer, f_extend, tier) across compute calls.  Returns (the pending
        blocks: the unsampled ones, then the sample's overflows; tuned pools
        per part or None; f_extend or None)."""
        K, o, J, errors = job.K, job.o, job.J, job.errors
        cal_tier = tiers[cal_idx]
        tuned_key = (K, errors, o, cal_tier.dimer, cal_tier.f_extend, cal_idx)
        entry = self._tuned_pools.get(tuned_key, "absent")
        if isinstance(entry, tuple):
            pools_e, fe_e = entry
            return pending, (pools_e if isinstance(pools_e, list) else None), fe_e
        base0 = infix_pool_schedule(plans, K - o, n_max, cal_tier.f_search / 4.0)
        if not (
            entry == "absent"
            and self._calibrate_enabled
            and job.collect_exact is None
            and not job.csv_needed
            and int(base0.sum()) >= 96
        ):
            return pending, None, None
        # measure on an 8x wider variant of the tier where memory allows:
        # counts are capped by the measuring program's own pools (candidates
        # = fan-out x pool), so a static-pool measurement cannot see demand
        # beyond 4x static; deep tiers whose 8x schedule would not fit a
        # 256-block batch measure at their own scale
        meas_tier = dataclasses.replace(cal_tier, f_search=cal_tier.f_search * 8)
        peak8 = int(infix_pool_schedule(plans, K - o, n_max,
                                        meas_tier.f_search / 4.0).max())
        if (3 << 20) // max(1, peak8) < 256:
            meas_tier = cal_tier
        # bound the batch by the measuring tier's full peak (infix pool and
        # the J x f_extend extension frontier)
        _, peak_meas = block_cost(meas_tier)
        B_cal = self._round(min(self._round(self._cal_batch),
                                max(64, (1 << 20) // max(1, peak_meas))))
        if len(pending) < 3 * B_cal:
            return pending, None, None
        idx = np.unique(np.linspace(0, len(pending) - 1, B_cal).astype(np.int64))
        sel = pending[idx]
        runs = self._runners_for(K, errors, o, J, B_cal, meas_tier, job.cap,
                                 job.params.rev_compl, with_occ=True)
        with tracing.span("engine.dispatch"):
            outs = self._run_batch(runs, job.layout, job.starts[sel], job.cnts[sel], B_cal)
        tracing.count("engine.batches")
        with tracing.span("engine.fetch"):
            outs = [{k: v.cpu().numpy() for k, v in out.items()} for out in outs]
        nb = len(sel)
        ovf = np.zeros(nb, bool)
        for out in outs:
            ovf |= out["overflow"][:nb]
        with tracing.span("engine.scatter"):
            self._scatter_batch(job.c, [out["hits"] for out in outs], job.cap,
                                job.starts[sel], job.cnts[sel], ~ovf)
        P_ = len(plans)
        # upper clamp: the next tier's scale (beyond the next rung the
        # ladder handles it)
        later = tiers[cal_idx + 1 :]
        has_wider = any(t.f_search > cal_tier.f_search for t in later)
        next_scale = max((t.f_search for t in later if t.f_search > cal_tier.f_search),
                         default=cal_tier.f_search) / 4.0
        tuned, ratios = [], []
        for pi, out in enumerate(outs):
            # overflowing blocks included: they are the heavy cohort the
            # pools must be provisioned for
            occ = out["occ"][:nb].astype(np.int64)  # [nb, T]
            # a part mesh's occ is already the max over parts: its one
            # shared program's pools are sized against the widest part
            n_pi = n_max if self.part_sharded else self.data.parts[pi].n_total
            base_pi = infix_pool_schedule(plans, K - o, n_pi, cal_tier.f_search / 4.0)
            clamp_pi = infix_pool_schedule(plans, K - o, n_pi, next_scale)
            # a block escalates if it exceeds the pool at ANY step: rank
            # blocks by their worst step demand relative to the static
            # schedule, drop the top 2% (they escalate), provision the
            # per-step max over the rest with x1.2+1 headroom
            ratio = (occ / np.maximum(base_pi[None, :], 1)).max(axis=1)
            kth = np.quantile(ratio, 0.98)
            kept = occ[ratio <= kth]
            dem = kept.max(axis=0) if len(kept) else occ.max(axis=0)
            # pools may decay at most one step behind demand: a down-resize
            # compacts the entering carry (the previous step's survivors)
            dem = dem.astype(np.float64)
            dem[1:] = np.maximum(dem[1:], dem[:-1])
            tp = np.array([_quant4(max(P_ + 1, 1.2 * dv + 1.0)) for dv in dem],
                          np.int64)
            tp = np.minimum(tp, np.maximum(base_pi, clamp_pi))
            tuned.append(tuple(int(x) for x in tp))
            ratios.append(float(tp.sum()) / max(1.0, float(base_pi.sum())))
        # adoption rule: a small tightening does not pay, a widening (the
        # residual cohorts) always does
        if 0.7 < max(ratios) <= 1.0:
            tuned = None
        # the last tier of the ladder never tightens: a block that fits the
        # static final tier but not the tuned one would have nowhere to go
        if not has_wider:
            tuned = None
        # extension frontier: the p90 of the sample's survivor counts (the
        # extension tree's root demand), clamped to [2, 8x static]
        surv = np.zeros(nb, np.int64)
        for out in outs:
            surv = np.maximum(surv, out["surv"][:nb].astype(np.int64))
        fe = int(np.clip(_quant4(1.2 * float(np.quantile(surv, 0.90)) + 1.0),
                         2, 8 * max(1, cal_tier.f_extend)))
        if fe == cal_tier.f_extend or (not has_wider and fe < cal_tier.f_extend):
            # final tier: widening f_extend is safe, tightening is not
            fe = None
        self._tuned_pools[tuned_key] = (tuned if tuned else "static", fe)
        mask = np.ones(len(pending), bool)
        mask[idx] = False
        pending = np.concatenate([pending[mask], sel[ovf]])
        if progress is not None:
            progress.add(int((~ovf).sum()))
        return pending, tuned, fe

    # ------------------------------------------------------------------
    # The split pipeline: phase-A infix collectors and per-rung phase-B
    # extenders.  Extension frontiers are sized to each block's measured
    # survivor count (fetched as one uint16 per block) instead of a whole
    # cohort padding to its worst member, and an extension overflow re-runs
    # only the extension at the next rung, with the same device-resident
    # states.

    # extension rungs; from _EXACT_RUNG_MIN on, the extension starts on the
    # exact path (below it, the fast path first, far-flagged blocks re-run
    # exact); dimer extension only in [_DIMER_RUNG_MIN, _DIMER_RUNG_MAX].
    # Mode ladder per block: fast-dimer -> exact-dimer -> exact-mono (far
    # advances the mode at the same rung, a capacity overflow the rung).
    # The JAX package's constants, so that the routing equals its.
    _RUNGS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
              16384, 32768)
    _EXACT_RUNG_MIN = 256
    _DIMER_RUNG_MIN = 16
    _DIMER_RUNG_MAX = 128

    def _extender(self, K, errors, o, J, B2, Fe, cap, rev_compl, exact,
                  dimer=False, fe_sched=None, with_occ=False) -> Extender:
        key = ("ext", K, errors, o, J, B2, Fe, cap, rev_compl, exact, dimer,
               fe_sched, with_occ)
        if key not in self._runners:
            self._runners[key] = Extender(
                self.indices[0], self.dtext, K=K, errors=errors, overlap=o, J=J,
                B=B2, Fe=Fe, cap=cap, rev_compl=rev_compl, exact=exact,
                dimer=dimer, fe_sched=fe_sched, with_occ=with_occ,
            )
        return self._runners[key]

    def _run_tier_split(self, job, t_i, tier, pending, B, tuned_i, start_tier,
                        progress, dimer_ext):
        """One tier of the split pipeline (one index part, plain counting),
        in the JAX engine's dispatch and drain order: up to 8 phase-A
        batches and 4 phase-B batches in flight (the per-level schedules
        adopted and the blocks per tier depend on it).

        Returns (far_blocks, cap_blocks, unresolved): infix far/cap
        overflows escalate tiers as on the fused path; `unresolved` are
        blocks whose extension exceeded the largest rung (the caller's
        static rescue pass takes them)."""
        K, o, J, errors, cap = job.K, job.o, job.J, job.errors, job.cap
        rev_compl = job.params.rev_compl
        layout, starts, cnts, c = job.layout, job.starts, job.cnts, job.c
        arun = self._runner(0, K, errors, o, J, B, tier, cap, rev_compl,
                            pools=None if tuned_i is None else tuned_i[0],
                            collect_only=True)
        stats = self.stats
        dev = self.device
        still_far: list[np.ndarray] = []
        still_cap: list[np.ndarray] = []
        unresolved: list[np.ndarray] = []
        inflight_a: list[tuple] = []
        inflight_b: list[tuple] = []
        limit = layout.start + layout.length

        def rung_of(surv):
            # headroom of the f_extend calibration rule (the frontier can
            # grow past the root during the tree split)
            need = 1.2 * float(surv) + 1.0
            for r in self._RUNGS:
                if r >= need:
                    return r
            return self._RUNGS[-1] if surv <= self._RUNGS[-1] else None

        def b_batch_size(Fe):
            b = max(2, SLOTS // max(1, J * Fe))
            return min(4096, 1 << int(np.log2(b)))

        def dispatch_b(a_out, rows, gids, Fe, exact, dimer):
            B2 = b_batch_size(Fe)
            for s in range(0, len(rows), B2):
                with tracing.span("engine.prep"):
                    rs = np.asarray(rows[s : s + B2], np.int32)
                    gs = np.asarray(gids[s : s + B2])
                    n = len(rs)
                    # pow2-padded batches (the JAX package's program shapes)
                    npad = min(B2, 1 << int(np.ceil(np.log2(max(2, n)))))
                    ridx = np.zeros(npad, np.int32)
                    ridx[:n] = rs
                    gstarts = np.zeros(npad, np.uint32)
                    gstarts[:n] = (layout.start + starts[gs]).astype(np.uint32)
                    bcnts = np.zeros(npad, np.int32)
                    bcnts[:n] = cnts[gs]
                    # per-level extension schedule: the first big-enough batch
                    # of a rung measures per-level demand; later batches run a
                    # decayed frontier schedule (demand shrinks down the tree)
                    skey = (K, errors, o, Fe, exact, dimer)
                    entry = self._ext_sched.get(skey)
                    sched = entry if isinstance(entry, tuple) else None
                    measure = (entry is None and Fe >= 64 and Fe < self._RUNGS[-1]
                               and n >= 32)
                    if measure:
                        self._ext_sched[skey] = "measuring"
                    run_b = self._extender(K, errors, o, J, npad, Fe, cap, rev_compl,
                                           exact, dimer=dimer, fe_sched=sched,
                                           with_occ=measure)
                with tracing.span("engine.dispatch"):
                    out = run_b(torch.from_numpy(gstarts.view(np.int32)).to(dev),
                                torch.from_numpy(bcnts).to(dev), limit,
                                (a_out["st"], a_out["valid"]),
                                torch.from_numpy(ridx).to(dev), n)
                inflight_b.append((gs, a_out, rs, Fe, exact, dimer, out, measure))
                rkey = (t_i, Fe, exact, dimer)
                stats["rung_batches"][rkey] = stats["rung_batches"].get(rkey, 0) + 1
                stats["rung_blocks"][rkey] = stats["rung_blocks"].get(rkey, 0) + n
                if self._record_tier_sel:
                    stats["rung_sel"].setdefault((t_i, Fe, exact, dimer), []).append(gs)

        def drain_b(one):
            while inflight_b and (len(inflight_b) >= 4 or one):
                gs, a_out, rs, Fe, exact, dimer, out, measure = inflight_b.pop(0)
                with tracing.span("engine.fetch"):
                    hits = out["hits"].cpu().numpy()
                    ovf = out["overflow"].cpu().numpy()
                    ovfc = out["overflow_cap"].cpu().numpy()
                n = len(gs)
                ok = ~ovf[:n]
                if measure:
                    skey = (K, errors, o, Fe, exact, dimer)
                    if ok.sum() >= 16:
                        occ = out["ext_occ"].cpu().numpy()[:n][ok].astype(np.int64)
                        dem = occ.max(axis=0).astype(np.float64)
                        # one level behind: the compaction into level l must
                        # hold level l-1's survivors
                        dem[1:] = np.maximum(dem[1:], dem[:-1])
                        sched = np.array(
                            [min(Fe, max(4, 1 << int(np.ceil(
                                np.log2(max(4.0, 1.2 * d + 1.0))))))
                             for d in dem], np.int64)
                        # adopt only a real shrink
                        if sched.sum() < 0.85 * Fe * len(dem):
                            self._ext_sched[skey] = tuple(int(x) for x in sched)
                        else:
                            self._ext_sched[skey] = "flat"
                    else:
                        self._ext_sched[skey] = "flat"
                with tracing.span("engine.scatter"):
                    for i in np.nonzero(ok)[0]:
                        i0 = int(starts[gs[i]])
                        cnt_i = int(cnts[gs[i]])
                        c[i0 : i0 + cnt_i] = hits[i, :cnt_i]
                bad = np.nonzero(~ok)[0]
                if len(bad):
                    capb = ovfc[:n][bad]
                    far_rows = bad[~capb]
                    if len(far_rows):
                        # far: advance the mode at the same rung —
                        # fast-dimer -> exact-dimer -> exact-mono
                        nm = (True, True) if dimer and not exact else (True, False)
                        dispatch_b(a_out, rs[far_rows], gs[far_rows], Fe, *nm)
                    cap_rows = bad[capb]
                    if len(cap_rows):
                        nxt = next((r for r in self._RUNGS if r > Fe), None)
                        if nxt is None:
                            unresolved.append(gs[cap_rows])
                        else:
                            dispatch_b(
                                a_out, rs[cap_rows], gs[cap_rows], nxt,
                                exact or nxt >= self._EXACT_RUNG_MIN,
                                dimer and self._DIMER_RUNG_MIN <= nxt <= self._DIMER_RUNG_MAX,
                            )
                if one:
                    break

        def drain_a(one):
            while inflight_a and (len(inflight_a) >= 8 or one):
                sel, a_out = inflight_a.pop(0)
                nb = len(sel)
                with tracing.span("engine.fetch"):
                    surv = a_out["surv"].cpu().numpy()[:nb]
                    ovf = a_out["overflow"].cpu().numpy()[:nb]
                    ovfc = a_out["overflow_cap"].cpu().numpy()[:nb]
                stats["overflow_blocks"] += int(ovf.sum())
                stats["max_tier"] = max(stats["max_tier"], t_i)
                tb = stats["tier_blocks"]
                tb[t_i] = tb.get(t_i, 0) + nb
                still_cap.append(sel[ovfc])
                still_far.append(sel[ovf & ~ovfc])
                okm = ~ovf
                # zero-survivor blocks: the infix neighbourhood is absent,
                # so every k-mer count is 0 and no extension runs
                for i in np.nonzero(okm & (surv == 0))[0]:
                    i0 = int(starts[sel[i]])
                    c[i0 : i0 + int(cnts[sel[i]])] = 0
                live = np.nonzero(okm & (surv > 0))[0]
                if len(live):
                    rungs = np.array([rung_of(x) for x in surv[live]])
                    for r in np.unique(rungs):
                        m = rungs == r
                        dispatch_b(
                            a_out, live[m], sel[live[m]], int(r),
                            int(r) >= self._EXACT_RUNG_MIN,
                            dimer_ext and self._DIMER_RUNG_MIN <= int(r) <= self._DIMER_RUNG_MAX,
                        )
                if t_i == start_tier and progress is not None:
                    progress.add(nb)
                drain_b(False)
                if one:
                    break

        for s in range(0, len(pending), B):
            sel = pending[s : s + B]
            with tracing.span("engine.dispatch"):
                outs = self._run_batch([arun], layout, starts[sel], cnts[sel], B)
            tracing.count("engine.batches")
            stats["phase_a_batches"] += 1
            inflight_a.append((sel, outs[0]))
            drain_a(False)
        while inflight_a:
            drain_a(True)
        while inflight_b:
            drain_b(True)
        cat = lambda xs: np.concatenate(xs) if xs else np.empty(0, np.int64)  # noqa: E731
        return cat(still_far), cat(still_cap), cat(unresolved)

    @tracing.spanned("engine.probe")
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
            with tracing.span("engine.dispatch"):
                out = self._run_batch(runs, job.layout, job.starts[sel], job.cnts[sel], Bp)
            with tracing.span("engine.fetch"):
                skip = out["skip"].cpu().numpy()[: len(sel)].astype(bool)
            with tracing.span("engine.scatter"):
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
            tracing.count("engine.batches")
            if progress is not None:
                progress.add(len(idx))
            if s == 0 and skip.mean() < 0.3:
                abandoned = True
        stats["probe_skipped"] = skipped
        pending = np.concatenate(residual) if residual else np.empty(0, np.int64)
        return pending, abandoned

    def _run_blocks(self, job, tier, ids, B, t_i, progress, pools_list=None):
        """Run the blocks `ids` at one tier in batches of B (at the parts'
        calibrated pools where given); scatter the resolved ones
        (frequencies summed over the parts, CSV locations, zero-error keys
        per part) and return (far-only, capacity) overflow ids (ORed over
        the parts)."""
        stats = self.stats
        runs = self._runners_for(job.K, job.errors, job.o, job.J, B, tier,
                                 job.cap, job.params.rev_compl,
                                 with_states=job.csv_needed,
                                 with_exact=job.collect_exact is not None,
                                 pools_list=pools_list)
        still_far: list[np.ndarray] = []
        still_cap: list[np.ndarray] = []
        for s in range(0, len(ids), B):
            sel = ids[s : s + B]
            nb = len(sel)
            with tracing.span("engine.dispatch"):
                outs = self._run_batch(runs, job.layout, job.starts[sel], job.cnts[sel], B)
            with tracing.span("engine.fetch"):
                outs = self._expand_part_outs(
                    [{k: (tuple(x.cpu().numpy() for x in v) if isinstance(v, tuple)
                          else v.cpu().numpy())
                      for k, v in out.items()}
                     for out in outs])
            with tracing.span("engine.scatter"):
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
            tracing.count("engine.batches")
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
