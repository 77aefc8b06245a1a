"""Lockstep (k,e)-search over blocks of adjacent k-mers, on torch tensors.

Port of `genmap_tpu/search/engine.py` (the fused per-tier programs on the
mono and on the dimer rank rows, with the unique-infix probe, occupancy
counts for the engine's calibration, and the split pipeline's two phases):

  * a batch of B blocks is processed at once; each block contributes one
    common overlap infix that is searched with every optimal search scheme
  * search states (bidirectional SA interval pair + error count) live in a
    capacity-bounded frontier; every step extends ALL states by ALL
    candidate characters (`kernels.candidate_step`), prunes by the scheme's
    (l, u) bounds and empty intervals, and compacts the frontier
    (`kernels.compact`)
  * surviving infix matches are extended to every k-mer window of the block
    along a binary doubling tree, again as a lockstep frontier over
    [B, nodes, Fe] states, and counted (`kernels.count_tail`)
  * frontier overflows are flagged per block and re-run at a higher capacity
    tier by the host — semantics stay exact, capacity only affects speed
  * the probe mode runs (a prefix of) the infix scan only and decides per
    block whether its survivor mass proves every k-mer frequency 1
    (`kernels.probe_mass`), so the host can skip the extension
  * a dimer tier (`Tier.dimer`) runs the same scan and tree on the dimer
    rank rows, two pattern characters per row read (`kernels.dimer_step`):
    plan steps fuse pairwise within each same-direction run, and a state
    that touches a flagged (sentinel/N-adjacent) sub-block or leaves the
    fast window flags its block to the next (mono) tier
  * the split pipeline's phase A (`BlockMapper(collect_only=True)`) stops
    after the infix scan and keeps the packed survivors on the device; its
    phase B (`Extender`) extends rows of them gathered into a batch sized to
    their survivor count

PyTorch runs eagerly, so the JAX package's `lax.scan` segments are Python
loops over steps; per-step plan attributes (needle position, direction,
error bounds) are small per-group tables the candidate kernel indexes by
each state's plan id.

State tensors: `st` int32 [R, B, F] with rows flo, rlo, size (uint32 bits),
err and — in the infix, R = 5 — the plan id; `valid` uint8 [B, F].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as Fn

from genmap_tpu_torch import kernels
from genmap_tpu_torch.ops.rank import (
    DeviceIndex,
    DeviceText,
    extract_needles,
)
from genmap_tpu_torch.search.schemes import plans_for


@dataclass(frozen=True)
class Tier:
    """Frontier capacities (infix search, collected survivors, extension) and
    the rank mode.

    `exact=False` uses the one-row fast rank path, which is exact only for
    intervals that fit the row's 1024-symbol window; wider intervals flag
    the block and it re-runs on the next (exact) tier.  `dimer=True`
    consumes TWO pattern characters per row read from the dimer rank rows;
    blocks touching a flagged (sentinel/N-adjacent) sub-block escalate to
    the next mono tier.  Capacity and rank mode only affect speed, never
    results."""

    f_search: int
    f_collect: int
    f_extend: int
    exact: bool = True
    dimer: bool = False
    # extension-phase rank mode override (None = follow `exact`).  Probe
    # residual cohorts run an exact infix but a fast one-row extension:
    # extension intervals are bounded by the block's survivor mass, so the
    # fast window almost always fits.
    ext_exact: bool | None = None


DEFAULT_TIERS = (
    Tier(4, 4, 1, exact=False),
    Tier(4, 4, 1),
    Tier(32, 64, 8),
    Tier(256, 512, 64),
    Tier(2048, 4096, 512),
    Tier(16384, 32768, 4096),
)


# pool sizes need not be powers of two: a [B, 3] frontier does 25% less work
# than [B, 4].  The fine rungs (2/3/6) are only used where the survivor
# count has low variance (branch estimate ~0); branchy steps keep
# power-of-two headroom.
_POOL_LADDER = (2, 3, 4, 6, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                8192, 16384)
_POOL_LADDER_COARSE = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                       8192, 16384)


def _quant4(v: float, cap: int = 16384, ladder=_POOL_LADDER) -> int:
    for q in ladder:
        if q >= v or q >= cap:
            return min(q, cap)
    return cap


def infix_pool_schedule(plans, infix_off, n_total, scale: float = 1.0):
    """Static per-step infix pool sizes.

    Branch states exist only where a scheme's u-bound allows errors; their
    number is bounded by the error-placement combinatorics, and a branch
    pattern of length t survives (size > 0) with probability
    ~min(1, 2n/4^t).  The pool of each STEP is sized from this estimate
    (x2 safety, quantized); overflow beyond it escalates the block."""
    pos_s, right_s, u_s, lreq_s = _plan_schedule(plans, infix_off)
    T, P = u_s.shape
    h = np.zeros(P, np.int64)
    pools = np.zeros(T, np.int64)
    for t in range(T):
        q = min(1.0, 2.0 * float(n_total) / 4.0 ** (t + 1))
        branch = 0.0
        for p in range(P):
            if u_s[t, p] > 0:
                h[p] += 1
            b = sum(
                math.comb(int(h[p]), j) * 3**j for j in range(int(u_s[t, p]) + 1)
            )
            branch += (b - 1) * q
        floor = _quant4(P + 1) if P == 1 else max(4, _quant4(P + 1))
        ladder = _POOL_LADDER if branch <= 0.2 else _POOL_LADDER_COARSE
        pools[t] = max(
            floor, _quant4((P + 1 + 2.0 * branch) * scale, ladder=ladder)
        )
    return pools


def exact_prefix_steps(n_total: int, target: int = 64) -> int:
    """Number of initial infix steps run on the exact two-row path in a fast
    tier: intervals start at size n_total and shrink ~4x per character, so
    after ceil(log4(n/target)) steps a typical interval fits the one-row
    window.  Blocks that stay wide longer are caught by `far`."""
    n = max(int(n_total), 1)
    return max(0, math.ceil(math.log(n / target, 4))) if n > target else 0


def _plan_schedule(plans, infix_off):
    """Stack all plans' step lists into [T, P] schedule arrays (pos, right,
    u, lreq).  Every plan consumes exactly the needle length, so all plans
    advance in lockstep."""
    T = plans[0].n_steps
    P = len(plans)
    pos = np.zeros((T, P), np.int32)
    right = np.zeros((T, P), bool)
    u = np.zeros((T, P), np.int32)
    lreq = np.zeros((T, P), np.int32)
    for p, plan in enumerate(plans):
        t = 0
        for seg in plan.segments:
            n = len(seg.pos)
            pos[t : t + n, p] = seg.pos + infix_off
            right[t : t + n, p] = seg.right
            u[t : t + n, p] = seg.u
            lreq[t : t + n, p] = seg.lreq
            t += n
        if t != T:
            raise ValueError(f"plan {p} covers {t} of {T} infix steps")
    return pos, right, u, lreq


def _plan_schedule_fused(plans, infix_off, t0: int) -> np.ndarray:
    """Fuse each plan's char steps [t0:] into 1- or 2-char dimer steps.

    Two consecutive chars fuse iff the plan consumes them in the same
    direction (segments are maximal same-direction runs, so only segment
    boundaries force single steps).  Plans finish after different fused-step
    counts; shorter plans pad with consume=0 (passthrough).  Returns [9, Tf,
    P] int32: consume, right, posA, posB, u_mid, u_end, l_mid, l_end, and
    charidx (chars consumed before the step; T for pad steps)."""
    pos_s, right_s, u_s, lreq_s = _plan_schedule(plans, infix_off)
    T, P = u_s.shape
    per_plan = []
    for p in range(P):
        steps = []
        i = t0
        while i < T:
            if i + 1 < T and right_s[i, p] == right_s[i + 1, p]:
                steps.append((2, right_s[i, p], pos_s[i, p], pos_s[i + 1, p],
                              u_s[i, p], u_s[i + 1, p], lreq_s[i, p],
                              lreq_s[i + 1, p], i))
                i += 2
            else:
                steps.append((1, right_s[i, p], pos_s[i, p], pos_s[i, p],
                              u_s[i, p], u_s[i, p], lreq_s[i, p], lreq_s[i, p], i))
                i += 1
        per_plan.append(steps)
    Tf = max(len(s) for s in per_plan) if per_plan else 0
    out = np.zeros((9, Tf, P), np.int32)
    out[8] = T  # charidx of pad steps
    for p, steps in enumerate(per_plan):
        for t, s in enumerate(steps):
            out[:, t, p] = s
    return out


def extension_extra_estimate(plans, infix_off, n_total) -> float:
    """Expected count of non-primary infix survivors (error-branch patterns
    of the full infix still present in the genome).  When non-negligible,
    tier 0 starts at f_extend=4 instead of overflowing many blocks."""
    _pos, _right, u_s, _lreq = _plan_schedule(plans, infix_off)
    T, P = u_s.shape
    q = min(1.0, 2.0 * float(n_total) / 4.0**T)
    extra = 0.0
    for p in range(P):
        h = int((u_s[:, p] > 0).sum())
        b = sum(math.comb(h, j) * 3**j for j in range(int(u_s[T - 1, p]) + 1))
        extra += (b - 1) * q
    return extra


def probe_thresholds(plans, infix_off, cut=None) -> np.ndarray:
    """Per-plan mass thresholds for the unique-infix probe's skip test.

    thr[p] = 1 for plans whose cumulative l-bound is still 0 after `cut`
    consumed chars (the self-match survives there), else 0 (any surviving
    row is a genuine second occurrence).  `cut=None` means the full scan.
    """
    _pos, _right, _u, lreq_s = _plan_schedule(plans, infix_off)
    T = lreq_s.shape[0]
    t = T if cut is None else max(1, min(T, int(cut)))
    return (lreq_s[:t].max(axis=0) == 0).astype(np.uint32)


def _compact(st, valid, F: int, count: bool = False):
    """Keep the first F valid states of every row ([R, rows, M] -> F),
    in order; returns (st, valid, overflowed [rows] bool), and with `count`
    also the rows' valid counts before the cut ([rows] int32)."""
    res = kernels.compact(st, valid, F, count)
    return (res[0], res[1], res[2].bool()) + tuple(res[3:])


def _u16(x: torch.Tensor) -> torch.Tensor:
    """Counts clipped to 65535 and stored as uint16, as the JAX package
    ships them."""
    return x.clamp(0, 65535).to(torch.uint16)


def _resize(st, valid, Fnew: int):
    """Grow the last axis by zero padding or shrink it by compaction;
    returns (st, valid, overflowed rows or None)."""
    Fold = st.shape[-1]
    if Fnew == Fold:
        return st, valid, None
    if Fnew > Fold:
        return Fn.pad(st, (0, Fnew - Fold)), Fn.pad(valid, (0, Fnew - Fold)), None
    R = st.shape[0]
    lead = st.shape[1:-1]
    out, v, of = _compact(st.reshape(R, -1, Fold), valid.reshape(-1, Fold), Fnew)
    return out.view(R, *lead, Fnew), v.view(*lead, Fnew), of.view(lead)


class _InfixSchedule:
    """Device-side per-step plan tables of the pooled infix scan."""

    def __init__(self, plans, infix_off, dev):
        pos_s, right_s, u_s, lreq_s = _plan_schedule(plans, infix_off)
        self.P = len(plans)
        self.T = len(pos_s)
        self.pos_np, self.u_np = pos_s, u_s
        self.pos = torch.as_tensor(pos_s, dtype=torch.int64, device=dev)
        self.right = torch.as_tensor(right_s, dtype=torch.uint8, device=dev)
        self.u = torch.as_tensor(u_s, dtype=torch.int32, device=dev)
        self.lreq = torch.as_tensor(lreq_s, dtype=torch.int32, device=dev)
        self.act = torch.ones(self.P, dtype=torch.uint8, device=dev)
        self._seed_pos: dict = {}

    def seed_pos(self, t_seed: int) -> torch.Tensor:
        """[P] int32: where each plan's first t_seed exact steps read their
        needle window (the lowest position they consume)."""
        if t_seed not in self._seed_pos:
            a = self.pos_np[:t_seed].min(axis=0) if t_seed else np.zeros(self.P)
            self._seed_pos[t_seed] = torch.as_tensor(
                a.astype(np.int32), device=self.pos.device)
        return self._seed_pos[t_seed]


def initial_states(index: DeviceIndex, sched: _InfixSchedule, needles,
                   t_seed: int, Fp: int, n_total: int):
    """The infix scan's starting pool ((st [5, B, Fp], valid [B, Fp])): slot
    p < P holds plan p's state after its first t_seed exact steps, looked up
    in the seed tables (`kernels.seed_lookup`, one launch for all plans), or
    the whole index when t_seed = 0."""
    return kernels.seed_lookup(index, needles, sched.seed_pos(t_seed), t_seed, Fp,
                               n_total)


def seed_steps(index: DeviceIndex, sched: _InfixSchedule, T: int) -> int:
    """Infix steps replaced by the seed lookup: every plan's exact opening,
    at most the tables' depth."""
    t_seed = 0
    if index.has_seed:
        t_seed = min(index.seed_t0, T)
        while t_seed > 0 and sched.u_np[:t_seed].max() > 0:
            t_seed -= 1
    return t_seed


def _search_infix(index: DeviceIndex, sched: _InfixSchedule, needles, B: int,
                  tier: Tier, n_total: int, exact_steps: int, pools,
                  stop_at=None, with_occ: bool = False):
    """All search schemes over one flat per-block state POOL.

    Every state carries its plan id.  On a fast tier the first
    `exact_steps` steps — where every interval is still wide — run on the
    exact two-row path and the rest on the one-row path, flagging still-wide
    states (`far`).  The seeded prefix replaces the first exact steps of
    every plan by one seed-table lookup.

    `stop_at` truncates the scan to its first stop_at steps (the probe's
    cut): survivor mass only shrinks as characters are consumed, so a mass
    that proves frequency 1 at a prefix proves it for the whole infix.

    `with_occ` also returns each step's count of valid candidates per block
    before the cut (occ [T, B] int32, the calibration signal; the seeded
    steps read the starting pool's valid count).

    Returns ((st [5, B, F], valid [B, F]), ovf_cap [B], ovf_far [B][, occ]):
    capacity overflow and far flags are reported separately so the engine
    can route far-only blocks to the same-size exact tier and capacity
    overflows to a wider tier."""
    dev = needles.device
    P, T = sched.P, sched.T
    if stop_at is not None:
        T = max(1, min(T, int(stop_at)))
    S = T if tier.exact else min(T, exact_steps)
    pools = np.asarray(pools, np.int64)

    t_seed = seed_steps(index, sched, T)
    S = max(S, t_seed)
    Fp = int(pools[t_seed]) if t_seed < T else int(pools[-1])

    st, valid = initial_states(index, sched, needles, t_seed, Fp, n_total)
    ovf_cap = torch.zeros(B, dtype=torch.bool, device=dev)
    ovf_far = torch.zeros(B, dtype=torch.bool, device=dev)
    occs = []
    if with_occ and t_seed > 0:
        occs.append(valid.sum(dim=-1, dtype=torch.int32)[None].expand(t_seed, B))

    Fcur = Fp
    for t in range(t_seed, T):
        F = int(pools[t])
        if F != Fcur:
            st, valid, of = _resize(st, valid, F)
            if of is not None:
                ovf_cap |= of
            Fcur = F
        nch = needles.index_select(1, sched.pos[t])  # [B, P]
        out, valid2, far = kernels.candidate_step(
            index, st.view(5, B * F), valid.view(B * F), per_block=F, inner=F,
            nch=nch, right=sched.right[t], act=sched.act, u=sched.u[t],
            lreq=sched.lreq[t], exact=t < S,
        )
        A = out.shape[-1]
        st, valid, of, *n = _compact(out.view(5, B, F * A), valid2.view(B, F * A), F,
                                     with_occ)
        ovf_cap |= of
        ovf_far |= far.view(B, F).bool().any(dim=-1)
        occs += [x[None] for x in n]
    out = ((st, valid), ovf_cap, ovf_far)
    return out + (torch.cat(occs),) if with_occ else out


class _DimerSchedule:
    """Device-side per-step tables of the pooled infix scan on the dimer
    rows: each plan's char steps after the seeded prefix (`t_seed` chars)
    fused into 1- or 2-char steps (`_plan_schedule_fused`), with the probe's
    cut applied; the starting pool F0, and per fused step its pool, rank
    mode and kind (whether any plan takes a 1-char step, whether any passes
    through)."""

    def __init__(self, plans, infix_off, t_seed: int, pools, tier: Tier,
                 exact_steps: int, stop_at, dev):
        T = plans[0].n_steps
        P = len(plans)
        pools = np.asarray(pools, np.int64)
        self.t_seed = t_seed
        self.F0 = int(pools[t_seed]) if t_seed < T else int(pools[-1])
        sched = _plan_schedule_fused(plans, infix_off, t_seed)
        Tf = sched.shape[1]
        if stop_at is not None:
            # truncate so NO plan consumes a char index >= the cut: the
            # probe's thresholds come from the l-bounds of the first `cut`
            # chars only, and a 2-char step straddling the cut would apply
            # the next char's l-bound (and kill the self-match there).
            # Steps wholly past the cut pass through; straddling 2-char
            # steps consume their first char only.
            cut = int(stop_at)
            sched = sched.copy()
            for p in range(P):
                for t in range(Tf):
                    ci, co = int(sched[8, t, p]), int(sched[0, t, p])
                    if co == 0 or ci + co <= cut:
                        continue
                    if ci >= cut:
                        sched[0, t, p] = 0
                        sched[8, t, p] = T
                    else:
                        sched[0, t, p] = 1
                        sched[3, t, p] = sched[2, t, p]  # posB = posA
                        sched[5, t, p] = sched[4, t, p]  # u_end = u_mid
                        sched[7, t, p] = sched[6, t, p]  # l_end = l_mid
            keep = [t for t in range(Tf) if (sched[0, t] > 0).any()]
            Tf = (max(keep) + 1) if keep else 0
            sched = sched[:, :Tf]
        charidx, consume = sched[8], sched[0]
        # a fused step's pool is the widest over its consumed char span: the
        # entering pool holds the previous step's end-char survivors
        self.pools = [
            max(int(pools[min(int(c), T - 1) : min(int(c) + max(1, int(k)), T)].max())
                if int(c) < T else int(pools[T - 1])
                for c, k in zip(charidx[t], consume[t]))
            for t in range(Tf)
        ]
        # exact (two-row) steps: any plan char in the exact prefix; an exact
        # tier runs every step exact
        ex_lim = T if tier.exact else min(exact_steps, T)
        self.exact = [bool((charidx[t] < ex_lim).any()) for t in range(Tf)]
        self.kind = [(bool((consume[t] == 1).any()), bool((consume[t] == 0).any()))
                     for t in range(Tf)]
        self.Tf = Tf
        # occupancy back in char space: char c reads the max over row 0 (the
        # post-seed pool, for c < t_seed) and every fused step (row t + 1)
        # whose consumed span covers c for any plan; an uncovered char reads
        # row 0 (the inverse of the pools' derivation above)
        cover = []
        for c in range(T):
            rows = [0] if c < t_seed else []
            for t in range(Tf):
                for p in range(P):
                    c0, k = int(charidx[t, p]), int(consume[t, p])
                    if k > 0 and c0 <= c < c0 + k:
                        rows.append(t + 1)
            cover.append(rows or [0])
        width = max((len(r) for r in cover), default=1)
        self.occ_cover = torch.as_tensor(
            [r + [r[0]] * (width - len(r)) for r in cover], dtype=torch.int64,
            device=dev).reshape(T, width)

        def tab(k, dtype):
            return torch.as_tensor(sched[k], dtype=dtype, device=dev)

        self.consume, self.right = tab(0, torch.uint8), tab(1, torch.uint8)
        self.posA, self.posB = tab(2, torch.int64), tab(3, torch.int64)
        self.u_mid, self.u_end = tab(4, torch.int32), tab(5, torch.int32)
        self.l_mid, self.l_end = tab(6, torch.int32), tab(7, torch.int32)


def _search_infix_dimer(index: DeviceIndex, sched: _InfixSchedule,
                        dsched: _DimerSchedule, needles, B: int, n_total: int,
                        with_occ: bool = False):
    """The pooled infix scan of `_search_infix` on the dimer rank rows: the
    same seeded prefix and plan-id-carrying pool, then `dsched`'s fused
    steps (two chars per row read where a plan's run allows, 1-char and
    passthrough slots where it does not), the first ones exact while any
    plan is in the exact prefix.  Returns ((st, valid), ovf_cap, ovf_far[,
    occ]) as `_search_infix` does; `far` also marks flagged sub-blocks, and
    the fused steps' counts are mapped back to char space
    (`dsched.occ_cover`)."""
    dev = needles.device
    st, valid = initial_states(index, sched, needles, dsched.t_seed, dsched.F0,
                               n_total)
    ovf_cap = torch.zeros(B, dtype=torch.bool, device=dev)
    ovf_far = torch.zeros(B, dtype=torch.bool, device=dev)
    occs = [valid.sum(dim=-1, dtype=torch.int32)[None]] if with_occ else []
    Fcur = dsched.F0
    for t in range(dsched.Tf):
        F = dsched.pools[t]
        if F != Fcur:
            st, valid, of = _resize(st, valid, F)
            if of is not None:
                ovf_cap |= of
            Fcur = F
        out, valid2, far = kernels.dimer_step(
            index, st.view(5, B * F), valid.view(B * F), per_block=F, inner=F,
            consume=dsched.consume[t], right=dsched.right[t],
            u_mid=dsched.u_mid[t], u_end=dsched.u_end[t],
            l_mid=dsched.l_mid[t], l_end=dsched.l_end[t],
            nchA=needles.index_select(1, dsched.posA[t]),
            nchB=needles.index_select(1, dsched.posB[t]),
            exact=dsched.exact[t], with_mono=dsched.kind[t][0],
            with_pass=dsched.kind[t][1],
        )
        st, valid, of, *n = _compact(out.view(5, B, -1), valid2.view(B, -1), F, with_occ)
        ovf_cap |= of
        ovf_far |= far.view(B, F).bool().any(dim=-1)
        occs += [x[None] for x in n]
    out = ((st, valid), ovf_cap, ovf_far)
    if not with_occ:
        return out
    return out + (torch.cat(occs)[dsched.occ_cover].amax(dim=1),)


def _balanced_schedule(n_right, n_left, pos_right, pos_left):
    """[T, M] (pos, right, act) arrays: slot m does its n_right[m] right
    steps then its n_left[m] left steps, all slots in lockstep."""
    M = len(n_right)
    T = int(max(int(n_right[m] + n_left[m]) for m in range(M)) if M else 0)
    pos = np.zeros((T, M), np.int32)
    right = np.zeros((T, M), bool)
    act = np.zeros((T, M), bool)
    for m in range(M):
        nr, nl = int(n_right[m]), int(n_left[m])
        for t in range(nr):
            pos[t, m] = pos_right[m][t]
            right[t, m] = True
            act[t, m] = True
        for t in range(nl):
            pos[nr + t, m] = pos_left[m][t]
            act[nr + t, m] = True
    return pos, right, act


def _balanced_schedule_fused(n_right, n_left, pos_right, pos_left):
    """Fused analog of `_balanced_schedule`: [4, T, M] (consume, right,
    posA, posB).  Each slot's right run then left run, chars fused pairwise
    within a run; odd runs end with one single-char step.  Slots pad with
    consume=0 (passthrough)."""
    M = len(n_right)
    per_slot = []
    for m in range(M):
        steps = []
        for is_right, run, posl in ((True, int(n_right[m]), pos_right[m]),
                                    (False, int(n_left[m]), pos_left[m])):
            i = 0
            while i < run:
                if i + 1 < run:
                    steps.append((2, is_right, posl[i], posl[i + 1]))
                    i += 2
                else:
                    steps.append((1, is_right, posl[i], posl[i]))
                    i += 1
        per_slot.append(steps)
    T = max((len(s) for s in per_slot), default=0)
    out = np.zeros((4, T, M), np.int32)
    for m, steps in enumerate(per_slot):
        for t, s in enumerate(steps):
            out[:, t, m] = (s[0], int(s[1]), s[2], s[3])
    return out


def _tree_levels(J: int, K: int) -> list:
    """Binary doubling-split plan over the k-mer range [0, J).

    Returns a list of levels; each level is (pmap, n_right, n_left,
    pos_right, pos_left) describing how every child slot derives from its
    parent (pmap) and which needle chars it consumes in each direction.
    A node covering k-mers [a, b) holds the needle span [b-1, a+K);
    splitting at m = (a+b)//2 extends the left child [a, m) LEFTWARD by b-m
    chars and the right child [m, b) RIGHTWARD by m-a chars.  Size-1 nodes
    pass through unchanged so the final leaf order is 0..J-1."""
    levels = []
    nodes = [(0, J)]
    while any(b - a > 1 for a, b in nodes):
        pmap, children = [], []
        n_right, n_left, pos_right, pos_left = [], [], [], []
        for i, (a, b) in enumerate(nodes):
            if b - a == 1:
                pmap.append(i)
                children.append((a, b))
                n_right.append(0)
                n_left.append(0)
                pos_right.append([])
                pos_left.append([])
            else:
                m = (a + b) // 2
                pmap.append(i)
                children.append((a, m))
                n_right.append(0)
                n_left.append(b - m)
                pos_right.append([])
                pos_left.append([b - 2 - t for t in range(b - m)])
                pmap.append(i)
                children.append((m, b))
                n_right.append(m - a)
                n_left.append(0)
                pos_right.append([a + K + t for t in range(m - a)])
                pos_left.append([])
        levels.append(
            (np.asarray(pmap, np.int32), n_right, n_left, pos_right, pos_left)
        )
        nodes = children
    if nodes != [(j, j + 1) for j in range(J)]:
        raise AssertionError("doubling tree does not end at the J leaves")
    return levels


class _ExtensionLevel:
    """Device-side tables of one doubling-tree level: the mono schedule, or
    with `dimer` the fused one (consume, right, posA, posB per step and
    node, and each step's kind)."""

    def __init__(self, level, errors, dev, dimer: bool = False):
        pmap, n_right, n_left, pos_right, pos_left = level
        M = len(pmap)
        self.M = M
        self.pmap = torch.as_tensor(pmap, dtype=torch.int64, device=dev)
        self.u = torch.full((M,), errors, dtype=torch.int32, device=dev)
        self.lreq = torch.zeros(M, dtype=torch.int32, device=dev)
        if dimer:
            f = _balanced_schedule_fused(n_right, n_left, pos_right, pos_left)
            self.T = f.shape[1]
            self.consume = torch.as_tensor(f[0], dtype=torch.uint8, device=dev)
            self.right = torch.as_tensor(f[1], dtype=torch.uint8, device=dev)
            self.posA = torch.as_tensor(f[2], dtype=torch.int64, device=dev)
            self.posB = torch.as_tensor(f[3], dtype=torch.int64, device=dev)
            self.kind = [(bool((f[0, t] == 1).any()), bool((f[0, t] == 0).any()))
                         for t in range(self.T)]
            return
        pos, right, act = _balanced_schedule(n_right, n_left, pos_right, pos_left)
        self.T = len(pos)
        self.pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
        self.right = torch.as_tensor(right, dtype=torch.uint8, device=dev)
        self.act = torch.as_tensor(act, dtype=torch.uint8, device=dev)


def _ext_phase(index, st, valid, ovf_cap, ovf_far, needles, lv: _ExtensionLevel,
               exact, with_occ: bool = False):
    """One mixed-direction extension scan over a [B, M, Fe] frontier; slots
    may move in different directions in the same step and inactive slots
    pass through.  `with_occ` also returns, per block, the max over steps
    and nodes of the candidate count before the cut ([B] int32, else
    None)."""
    R, B, M, Fe = st.shape
    occ = torch.zeros(B, dtype=torch.int32, device=st.device) if with_occ else None
    for t in range(lv.T):
        nch = needles.index_select(1, lv.pos[t])  # [B, M]
        # left- and right-moving nodes share one launch: both directions
        # read the same FMD rows
        out, valid2, far = kernels.candidate_step(
            index, st.view(R, -1), valid.view(-1), per_block=M * Fe,
            inner=Fe, nch=nch, right=lv.right[t], act=lv.act[t], u=lv.u,
            lreq=lv.lreq, exact=exact,
        )
        A = out.shape[-1]
        st, valid, of, *n = _compact(out.view(R, B * M, Fe * A),
                                     valid2.view(B * M, Fe * A), Fe, with_occ)
        st = st.view(R, B, M, Fe)
        valid = valid.view(B, M, Fe)
        ovf_cap = ovf_cap | of.view(B, M).any(dim=-1)
        ovf_far = ovf_far | far.view(B, M * Fe).bool().any(dim=-1)
        if with_occ:
            occ = torch.maximum(occ, n[0].view(B, M).amax(dim=-1))
    return st, valid, ovf_cap, ovf_far, occ


def _ext_phase_fused(index, st, valid, ovf_cap, ovf_far, needles,
                     lv: _ExtensionLevel, exact, with_occ: bool = False):
    """`_ext_phase` on the dimer rows: slots consume 2 chars per step within
    a run, 1 at its odd end, 0 once done (passthrough).  The extension's
    error bound is one cumulative cap, so the mid-pair check is implied."""
    R, B, M, Fe = st.shape
    occ = torch.zeros(B, dtype=torch.int32, device=st.device) if with_occ else None
    for t in range(lv.T):
        out, valid2, far = kernels.dimer_step(
            index, st.view(R, -1), valid.view(-1), per_block=M * Fe, inner=Fe,
            consume=lv.consume[t], right=lv.right[t], u_mid=lv.u, u_end=lv.u,
            l_mid=lv.lreq, l_end=lv.lreq,
            nchA=needles.index_select(1, lv.posA[t]),
            nchB=needles.index_select(1, lv.posB[t]), exact=exact,
            with_mono=lv.kind[t][0], with_pass=lv.kind[t][1],
        )
        st, valid, of, *n = _compact(out.view(R, B * M, -1), valid2.view(B * M, -1),
                                     Fe, with_occ)
        st = st.view(R, B, M, Fe)
        valid = valid.view(B, M, Fe)
        ovf_cap = ovf_cap | of.view(B, M).any(dim=-1)
        ovf_far = ovf_far | far.view(B, M * Fe).bool().any(dim=-1)
        if with_occ:
            occ = torch.maximum(occ, n[0].view(B, M).amax(dim=-1))
    return st, valid, ovf_cap, ovf_far, occ


def _extend_to_kmers(index, survivors, needles, levels, B: int, tier: Tier,
                     fe_sched=None, with_occ: bool = False):
    """Extend infix survivors to every k-mer window of each block along the
    doubling tree (`_tree_levels`): ~2·log2(J) extension steps per k-mer,
    left- and right-moving slots sharing each step.  A dimer tier runs the
    fused steps on the dimer rows (`ext_exact` still picks the rank mode: a
    forced exact dimer tier computes wide intervals instead of flagging).

    `fe_sched` ([levels + 1] ints) sets a frontier width per level (index
    0: the root compaction), shrinking by compaction (overflow is a
    capacity overflow) or growing by zero padding; default: f_extend
    throughout.  `with_occ` also returns ext_occ [B, levels + 1] uint16:
    the root's survivor count, then per level the max over its steps and
    nodes of the candidate counts before the cut, or on a stepless level
    the max over nodes of the carried valid count.

    Returns ((st [4, B, J, Fe], valid [B, J, Fe]), ovf_cap, ovf_far[,
    ext_occ])."""
    exact = tier.exact if tier.ext_exact is None else tier.ext_exact
    if fe_sched is None:
        fe_sched = [tier.f_extend] * (len(levels) + 1)
    if len(fe_sched) != len(levels) + 1:
        raise ValueError(f"fe_sched has {len(fe_sched)} widths for {len(levels)} levels")
    s_st, s_valid = survivors
    # compact survivors into the root slots (node covering [0, J))
    F0 = int(fe_sched[0])
    st, valid, ovf_cap, *occs = _compact(s_st[:4], s_valid, F0, with_occ)
    st = st.view(4, B, 1, F0)
    valid = valid.view(B, 1, F0)
    ovf_far = torch.zeros(B, dtype=torch.bool, device=needles.device)
    for li, lv in enumerate(levels):
        st = st.index_select(2, lv.pmap)
        valid = valid.index_select(1, lv.pmap)
        st, valid, of = _resize(st, valid, int(fe_sched[li + 1]))
        if of is not None:
            ovf_cap = ovf_cap | of.any(dim=-1)
        occ_l = None
        if lv.T:
            phase = _ext_phase_fused if tier.dimer else _ext_phase
            st, valid, ovf_cap, ovf_far, occ_l = phase(
                index, st, valid, ovf_cap, ovf_far, needles, lv, exact, with_occ
            )
        if with_occ:
            if occ_l is None:  # stepless level: demand = the carried states
                occ_l = valid.sum(dim=-1, dtype=torch.int32).amax(dim=-1)
            occs.append(occ_l)
    out = ((st, valid), ovf_cap, ovf_far)
    return out + (_u16(torch.stack(occs, dim=1)),) if with_occ else out


def _count_tail(index, states, cnt, J: int, cap: int, rev_compl: bool,
                with_exact: bool = False):
    """Per-k-mer saturating counts [B, J] uint16 from the final states, and
    with `with_exact` the zero-error interval outputs (kernels.count_tail)."""
    st, valid = states
    return kernels.count_tail(index, st.reshape(st.shape[0], -1),
                              valid.reshape(-1), cnt, J, cap, rev_compl,
                              with_exact)


class BlockMapper:
    """The batch mapper of one configuration (port of `make_block_mapper`'s
    fused program, and of its `probe_only` program with `probe=True`).

    Call with starts [B] int32 (uint32 global base positions), cnt [B] int32
    (valid k-mers per block) and limit (exclusive end of the current file's
    bases).  Returns dict(hits [B, J] uint16 clamped to cap, overflow [B]
    bool, overflow_cap [B] bool) as device tensors.  The index holds both
    strands, so one pass yields the combined forward + reverse-complement
    frequency; rev_compl=False subtracts the reverse-strand occurrences
    through the strand rank rows.  A dimer tier needs an index part with
    dimer rows.

    `with_exact` (the dedup key pre-pass) or `with_states` (CSV) add
    exact_size, exact_size_total and exact_flo ([B, J] int32 holding
    uint32, see kernels.count_tail); `with_states` also returns the final
    extension states as states = (flo, size, err, valid), each [B, J, Fe].

    `probe=True` runs the infix scan only, truncated at `probe_cut` steps,
    and returns dict(skip [B] uint8): a skipped block's k-mers all have
    frequency 1.  On a multi-part index the call of each part but the last
    passes last=False and returns dict(acc=...), the running per-plan mass
    sum that the next part's call takes as `acc` (kernels.probe_mass).
    `probe_mass=True` (tests) adds mass_p [B, P] int32, nwin [B] uint8 and
    overflow [B] uint8.

    `pools` (per-step ints, char space on a dimer tier too) replaces the
    static infix pool schedule with the engine's calibrated one.
    `with_occ` adds occ [B, T] uint16 (each infix step's valid candidates
    per block before the cut) and surv [B] uint16 (the infix survivors),
    both clipped to 65535.  `collect_only=True` is the split pipeline's
    phase A: the infix scan only, its survivors packed to the front of
    their slots at the final pool's width Fc, returned as device tensors
    st [4, B, Fc] int32 (flo, rlo, size, err) and valid [B, Fc], with
    surv [B] uint16, overflow and overflow_cap.

    `n_static` sizes the pool schedule and the exact prefix for an index of
    that many symbols instead of this part's (the part mesh: every device
    runs the schedule of the largest part).  With a data mesh (`mesh`,
    parallel/mesh.py) each rank maps its rows of the batch and the outputs
    are gathered over the data line, so every rank returns the whole
    batch's (port of make_block_mapper's shard_map branch); a probe call
    with last=False returns this rank's running sum only."""

    def __init__(self, index: DeviceIndex, dtext: DeviceText, *, K: int,
                 errors: int, overlap: int, J: int, B: int, tier: Tier,
                 cap: int, rev_compl: bool, with_exact: bool = False,
                 with_states: bool = False, probe: bool = False,
                 probe_cut=None, probe_mass: bool = False, pools=None,
                 with_occ: bool = False, collect_only: bool = False,
                 n_static: int | None = None, mesh=None):
        if overlap != K - J + 1:
            raise ValueError(f"overlap {overlap} != K - J + 1 = {K - J + 1}")
        if not 0 < cap <= 65535:
            raise ValueError(
                f"cap must be in [1, 65535] (uint16 result path), got {cap}"
            )
        if tier.dimer and not index.has_dimer:
            raise ValueError("dimer tier on an index part without dimer rows")
        dev = index.device
        self.index, self.dtext = index, dtext
        self.K, self.errors, self.J, self.B = K, errors, J, B
        self.tier, self.cap, self.rev_compl = tier, cap, rev_compl
        self.with_exact, self.with_states = with_exact, with_states
        self.probe, self.probe_cut, self.probe_mass = probe, probe_cut, probe_mass
        self.with_occ, self.collect_only = with_occ, collect_only
        self.mesh = mesh
        self.Ln = K + J - 1
        plans = plans_for(errors, overlap)
        infix_off = K - overlap
        self.n_total = index.n_total
        n_sched = self.n_total if n_static is None else n_static
        # the dimer rows' fast window is 256 symbols: intervals must shrink
        # to ~16 before the fast steps start
        self.exact_steps = exact_prefix_steps(n_sched, 16 if tier.dimer else 64)
        self.pools = (infix_pool_schedule(plans, infix_off, n_sched,
                                          tier.f_search / 4.0)
                      if pools is None else np.asarray(pools, np.int64))
        self.sched = _InfixSchedule(plans, infix_off, dev)
        self.dsched = None
        if tier.dimer:
            self.dsched = _DimerSchedule(
                plans, infix_off, seed_steps(index, self.sched, self.sched.T),
                self.pools, tier, self.exact_steps,
                probe_cut if probe else None, dev,
            )
        self.levels = [_ExtensionLevel(lv, errors, dev, tier.dimer)
                       for lv in _tree_levels(J, K)]
        self.thr = torch.as_tensor(
            probe_thresholds(plans, infix_off, probe_cut).astype(np.int32),
            device=dev,
        )

    def __call__(self, starts, cnt, limit, acc=None, last: bool = True):
        if self.mesh is None:
            return self._run(starts, cnt, limit, acc, last)
        from genmap_tpu_torch.parallel.dist import fetch, put_global_batch

        out = self._run(put_global_batch(starts, self.mesh),
                        put_global_batch(cnt, self.mesh), limit, acc, last)
        return out if self.probe and not last else fetch(out, self.mesh)

    def _run(self, starts, cnt, limit, acc=None, last: bool = True):
        """The batch on this device alone."""
        B = starts.shape[0]
        needles = extract_needles(self.dtext, starts, self.Ln, limit)
        if self.tier.dimer:
            (s_st, s_valid), cap1, far1, *occ = _search_infix_dimer(
                self.index, self.sched, self.dsched, needles, B, self.n_total,
                self.with_occ,
            )
        else:
            (s_st, s_valid), cap1, far1, *occ = _search_infix(
                self.index, self.sched, needles, B, self.tier, self.n_total,
                self.exact_steps, self.pools,
                stop_at=self.probe_cut if self.probe else None,
                with_occ=self.with_occ,
            )
        if self.probe:
            ovf = (cap1 | far1).to(torch.uint8)
            res = kernels.probe_mass(s_st, s_valid, ovf, needles, self.thr,
                                     self.index.has_n, self.probe_mass,
                                     acc=acc, last=last)
            if not last:
                return dict(acc=res)
            if not self.probe_mass:
                return dict(skip=res)
            skip, mass_p, nwin = res
            return dict(skip=skip, mass_p=mass_p, nwin=nwin, overflow=ovf)
        if self.collect_only:
            # phase A: survivors packed at native width (no overflow: they
            # already fit it), the pack's count is the survivor count
            st, valid, _, surv = _compact(s_st[:4], s_valid, s_st.shape[-1], count=True)
            return dict(st=st, valid=valid, surv=_u16(surv),
                        overflow=cap1 | far1, overflow_cap=cap1)
        states, cap2, far2 = _extend_to_kmers(
            self.index, (s_st, s_valid), needles, self.levels, B, self.tier
        )
        exact = self.with_exact or self.with_states
        res = _count_tail(self.index, states, cnt, self.J, self.cap,
                          self.rev_compl, exact)
        out = dict(
            hits=res[0] if exact else res,
            overflow=cap1 | far1 | cap2 | far2,
            overflow_cap=cap1 | cap2,
        )
        if exact:
            out.update(exact_size=res[1], exact_size_total=res[2],
                       exact_flo=res[3])
        if self.with_states:
            st, valid = states
            out["states"] = (st[0], st[2], st[3], valid)
        if self.with_occ:
            out["occ"] = _u16(occ[0].T)
            out["surv"] = _u16(s_valid.sum(dim=-1, dtype=torch.int32))
        return out


class Extender:
    """The split pipeline's phase B (port of `make_extender`, with the
    engine's rung gather): gather rows of device-resident phase-A survivor
    states into a batch at one extension rung Fe (`kernels.gather_states`),
    extend them to every k-mer window of their blocks, and count.

    The tier is Tier(4, max(4, Fe), Fe, exact=exact, dimer=dimer,
    ext_exact=exact): `exact=False` runs the one-row fast rank path (far
    flags re-run at the same rung on the exact path), `dimer` the fused
    steps on the dimer rows.  `fe_sched` applies a measured per-level
    frontier schedule (`_extend_to_kmers`); `with_occ` adds ext_occ [B,
    levels + 1] uint16, the per-level demand that calibrates it.

    Call with starts [B] int32 (uint32 global base positions of the batch's
    blocks), cnt [B], limit, phase_a = (st [4, Bc, Fc] int32, valid [Bc,
    Fc] uint8) of phase A (`BlockMapper(collect_only=True)`), and ridx [B]
    int32: the phase-A row of each of the first n blocks (rows past n are
    padding).  Returns dict(hits [B, J] uint16, overflow, overflow_cap[,
    ext_occ])."""

    def __init__(self, index: DeviceIndex, dtext: DeviceText, *, K: int,
                 errors: int, overlap: int, J: int, B: int, Fe: int, cap: int,
                 rev_compl: bool, exact: bool, dimer: bool = False,
                 fe_sched=None, with_occ: bool = False):
        if overlap != K - J + 1:
            raise ValueError(f"overlap {overlap} != K - J + 1 = {K - J + 1}")
        if dimer and not index.has_dimer:
            raise ValueError("dimer extension on an index part without dimer rows")
        self.index, self.dtext = index, dtext
        self.J, self.B, self.Fe, self.cap, self.rev_compl = J, B, Fe, cap, rev_compl
        self.tier = Tier(4, max(4, Fe), Fe, exact=exact, dimer=dimer, ext_exact=exact)
        self.fe_sched = None if fe_sched is None else tuple(int(x) for x in fe_sched)
        self.with_occ = with_occ
        self.Ln = K + J - 1
        self.levels = [_ExtensionLevel(lv, errors, index.device, dimer)
                       for lv in _tree_levels(J, K)]

    def __call__(self, starts, cnt, limit, phase_a, ridx, n: int):
        B = starts.shape[0]
        states = kernels.gather_states(phase_a[0], phase_a[1], ridx, n, self.Fe)
        needles = extract_needles(self.dtext, starts, self.Ln, limit)
        final, cap2, far2, *occ = _extend_to_kmers(
            self.index, states, needles, self.levels, B, self.tier,
            self.fe_sched, self.with_occ,
        )
        hits = _count_tail(self.index, final, cnt, self.J, self.cap, self.rev_compl)
        out = dict(hits=hits, overflow=cap2 | far2, overflow_cap=cap2)
        if self.with_occ:
            out["ext_occ"] = occ[0]
        return out
