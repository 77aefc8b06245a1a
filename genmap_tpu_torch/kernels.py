"""The port's hand-written CUDA kernels: build, bind, launch, plain versions.

Eleven kernels carry `map`, and a twelfth measures the rank-row reads they
are built on (sources in `csrc/`, compiled with nvcc for sm_90a into one
shared library each, loaded with ctypes):

  extract_needles  needle windows from the packed text
  candidate_step   FMD extension of every search state by every character,
                   complement permutation, error count and pruning
  compact          first F valid candidates of every frontier row, in order
  count_tail       per-k-mer saturating occurrence counts (+ strand split),
                   and on request each k-mer's zero-error interval
  probe_mass       the unique-infix probe's per-plan survivor mass and skip,
                   summed over the parts of a multi-part index (or, on a
                   part mesh, decided from the sum over devices)
  locate           SA rows to (sequence, position) by LF walks (CSV, -ep)
  dimer_step       the candidate step on the dimer rank rows: 0, 1 or 2
                   characters per state and row read
  seed_lookup      the infix scan's starting pool from the seed tables
  gather_states    the split pipeline's rung gather of phase-A survivor rows
  seed_build       the seed tables: the FMD interval of every ACGT string of
                   length 0..t0 (once per index part, at upload)
  row_gather       the sum of random table rows, and dependent chains of
                   row reads (the Pallas row-DMA harness's function; run by
                   `experiments/row_gather.py`, not by `map`)
  extend_level     consecutive levels of the doubling-tree extension: every
                   step of a level and its compaction, each (block, node)
                   frontier kept on chip

Each wrapper takes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version beside it (the CPU tests' path and the reference the kernel
is held against on the card).  A wrapper never falls back: a CUDA tensor
launches the kernel or raises.  Each kernel keeps a launch counter that is
raised by one at every launch, and nowhere else.

The libraries are built at first use into `_build/` beside this file (listed
in .gitignore), named by a hash of their source and flags; `build()` starts
one nvcc per source in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch
import torch.nn.functional as Fn

from genmap_tpu_torch.index.fmindex import D_WIDTH, sub_width
from genmap_tpu_torch.ops import rank

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong


class Kernel:
    """One CUDA source compiled into its own shared library."""

    def __init__(self, name: str, source: str, replaces: str, argtypes,
                 entries=None):
        self.name = name
        self.source = source  # file name under csrc/
        self.replaces = replaces  # file:line of the JAX function it ports
        # C entry points genmap_<name><suffix> -> argtypes ("" is the main
        # one; argtypes None: the source has only suffixed entries)
        self.entries = {**({"": argtypes} if argtypes is not None else {}),
                        **(entries or {})}
        self.launches = 0
        self._fns: dict = {}

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC, self.source)

    def lib_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in (self.source_path, os.path.join(CSRC, "genmap.cuh")):
            with open(path, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def fn(self, entry: str = ""):
        """The bound C entry point `genmap_<name><entry>` (built on first
        use)."""
        if entry not in self._fns:
            build([self])
            lib = ctypes.CDLL(self.lib_path())
            fn = getattr(lib, f"genmap_{self.name}{entry}")
            fn.argtypes = self.entries[entry]
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        return self._fns[entry]

    def launch(self, *args, entry: str = "") -> None:
        err = self.fn(entry)(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name}{entry} failed to launch: cudaError_t {err}"
            )
        self.launches += 1


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH)")
    return path


def build(kernels=None) -> dict[str, str]:
    """Compile the given kernels (default: all) that are not built yet, one
    nvcc process per source, all started together.  Returns each newly
    built kernel's compiler report (registers, spills); raises with nvcc's
    output when a build fails."""
    todo = [k for k in (kernels or KERNELS.values())
            if not os.path.exists(k.lib_path())]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in todo:
        out = k.lib_path()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, k.source_path]
        procs.append((k, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    reports, failed = {}, []
    for k, out, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"--- {k.source} (exit {p.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, out)
        reports[k.name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


# ---------------------------------------------------------------------------
# 1. extract_needles
# ---------------------------------------------------------------------------

EXTRACT_NEEDLES = Kernel(
    "extract_needles", "extract_needles.cu", "genmap_tpu/ops/rank.py:698",
    [_P, _P, _I, _P, _I, _I, _U, _U, _P, _P],
)


def extract_needles_plain(words, nwords, starts, Ln: int, limit: int,
                          text_limit: int) -> torch.Tensor:
    """Plain PyTorch version of `extract_needles`."""
    pos = rank.u32(starts)[:, None] + torch.arange(Ln, dtype=torch.int64,
                                                  device=starts.device)
    valid = pos < limit
    pc = pos.clamp(max=text_limit - 1)
    code = (rank.u32(words[pc >> 4]) >> ((pc & 15) * 2)) & 3
    if nwords.shape[0] > 0:
        nbit = (rank.u32(nwords[pc >> 5]) >> (pc & 31)) & 1
        code = torch.where(nbit == 1, 4, code)
    return torch.where(valid, code, 0).to(torch.uint8)


def extract_needles(words, nwords, starts, Ln: int, limit: int,
                    text_limit: int) -> torch.Tensor:
    """[B, Ln] uint8 needle windows at the global base positions `starts`
    ([B] int32 holding uint32) of the packed text; positions >= `limit`
    read as code 0 and N bases as code 4."""
    if not starts.is_cuda:
        return extract_needles_plain(words, nwords, starts, Ln, limit,
                                     text_limit)
    dev = starts.device
    _check(starts, "starts", torch.int32, device=dev)
    _check(words, "words", torch.int32, device=dev)
    _check(nwords, "nwords", torch.int32, device=dev)
    B = starts.shape[0]
    out = torch.empty((B, Ln), dtype=torch.uint8, device=dev)
    EXTRACT_NEEDLES.launch(
        words.data_ptr(), nwords.data_ptr(), int(nwords.shape[0] > 0),
        starts.data_ptr(), B, Ln, int(limit), int(text_limit - 1),
        out.data_ptr(), _stream(starts),
    )
    return out


# ---------------------------------------------------------------------------
# 2. candidate_step
# ---------------------------------------------------------------------------

CANDIDATE_STEP = Kernel(
    # _candidate_step_dir, with ops/rank.py:259 extend_core and :280
    # extend_core_fast folded in
    "candidate_step", "candidate_step.cu", "genmap_tpu/search/engine.py:217",
    [_P, _I, _I, _P, _P, _I, _P, _L, _L, _L, _I, _P, _P, _P, _P, _P, _I, _I,
     _I, _P, _P, _P, _P],
)


def _state_groups(st, per_block, inner, G):
    N = st.shape[1]
    i = torch.arange(N, dtype=torch.int64, device=st.device)
    grp = st[4].to(torch.int64) if st.shape[0] == 5 else (i % per_block) // inner
    return i // per_block, grp.clamp(0, G - 1)


def candidate_step_plain(index, st, valid, *, per_block, inner, nch, right,
                         act, u, lreq, exact):
    """Plain PyTorch version of `candidate_step` (same arguments, same
    results).  Only valid active states are computed: invalid ones give
    all-zero outputs and inactive ones pass through, as in the kernel."""
    R, N = st.shape
    A = index.nchars
    G = right.shape[0]
    dev = st.device
    blk, g = _state_groups(st, per_block, inner, G)
    v = valid.bool()
    actv = act.bool()[g]
    cand = torch.arange(A, dtype=torch.int64, device=dev)[None, :]

    # inactive states pass through unchanged (candidate slot 0 keeps them)
    out = torch.zeros((R, N, A), dtype=torch.int32, device=dev)
    idle = torch.nonzero(~actv).squeeze(1)
    out[:, idle] = st[:, idle, None]
    valid2 = ~actv[:, None] & v[:, None] & (cand == 0)
    far = torch.zeros(N, dtype=torch.bool, device=dev)

    w = torch.nonzero(v & actv).squeeze(1)
    g, blk = g[w], blk[w]
    flo, rlo, size = (rank.u32(st[r, w]) for r in range(3))
    rightv = right.bool()[g]
    mlo = torch.where(rightv, rlo, flo)
    olo = torch.where(rightv, flo, rlo)
    if exact:
        nmlo, nsize, nolo = rank.extend_core(index, mlo, size, olo)
        far_w = torch.zeros(w.shape[0], dtype=torch.bool, device=dev)
    else:
        nmlo, nsize, nolo, far_w = rank.extend_core_fast(index, mlo, size, olo)
    perm = torch.tensor(rank.comp_perm(A), device=dev)
    rb = rightv[:, None]
    nflo = torch.where(rb, nolo[:, perm], nmlo)
    nrlo = torch.where(rb, nmlo[:, perm], nolo)
    nsz = torch.where(rb, nsize[:, perm], nsize)
    ch = nch.to(torch.int64)[blk, g][:, None]
    err2 = st[3, w].to(torch.int64)[:, None] + ((cand != ch) | (ch == 4)).to(torch.int64)
    ok = (
        (err2 <= u.to(torch.int64)[g][:, None])
        & (err2 >= lreq.to(torch.int64)[g][:, None])
        & (nsz > 0)
        & ~far_w[:, None]
    )
    outs = [nflo, nrlo, nsz, err2]
    if R == 5:
        outs.append(g[:, None].expand(-1, A))
    out[:, w] = rank.as_i32(torch.stack(outs))
    valid2[w] = ok
    far[w] = far_w
    return out, valid2.to(torch.uint8), far.to(torch.uint8)


def candidate_step_defined(st, valid, act, per_block: int, inner: int,
                           A: int) -> torch.Tensor:
    """[N, A] bool: the slots of `candidate_step`'s out that its contract
    defines (every candidate of a valid active state, candidate 0 of a
    valid passthrough state)."""
    _blk, g = _state_groups(st, per_block, inner, act.shape[0])
    cand0 = torch.arange(A, device=st.device)[None, :] == 0
    return valid.bool()[:, None] & (act.bool()[g][:, None] | cand0)


def candidate_step_view(res, *, st, valid, act, per_block: int, inner: int, **_):
    """What a consumer can read of a `candidate_step` result `res` (called
    with the step's own arguments): out with the undefined slots zeroed,
    valid2, far, and the engine's compaction of out by valid2 (rows of
    `inner` states, `compact_plain`).  Two results agree under the contract
    when their views are equal."""
    out, valid2, far = res
    R, N, A = out.shape
    defined = candidate_step_defined(st, valid, act, per_block, inner, A)
    rows = N // inner
    kept = compact_plain(out.reshape(R, rows, inner * A),
                         valid2.reshape(rows, inner * A), inner)
    return (torch.where(defined[None], out, 0), valid2, far, *kept)


def candidate_step(index, st, valid, *, per_block: int, inner: int, nch,
                   right, act, u, lreq, exact: bool):
    """One search step of N states by every candidate character.

    st: [R, N] int32 — rows flo, rlo, size (uint32 bits), err, and for R = 5
    the plan id.  valid: [N] uint8.  State i belongs to block i // per_block
    and to group st[4, i] (R = 5) or (i % per_block) // inner (R = 4); a
    group is a search plan (infix) or a tree node (extension).  Per group:
    right / act [G] uint8 (extension side; inactive states pass through),
    u / lreq [G] int32 error bounds; nch [N // per_block, G] uint8 is the
    needle character each (block, group) consumes.  `exact` reads one row
    per bound; otherwise one paired row, raising `far` for intervals wider
    than its window.

    Returns (out [R, N, A] int32, valid2 [N, A] uint8, far [N] uint8): slot
    c of `out` is the state extended by character c (err counting c != nch
    or nch == N), pruned in valid2 by the bounds, empty intervals and far.

    Contract: valid2 and far are written for every state; out[:, i, :] is
    defined where state i is valid and active, out[:, i, 0] where it is
    valid and passes through (it holds the state), and every other slot of
    out is undefined (the kernel leaves it as allocated;
    `candidate_step_defined`).  compact reads only slots whose valid2 is 1;
    the seed-table build passes every state valid and active.  The plain
    version fills the undefined slots (zeros, passthrough copies).
    """
    if not st.is_cuda:
        return candidate_step_plain(index, st, valid, per_block=per_block,
                                    inner=inner, nch=nch, right=right,
                                    act=act, u=u, lreq=lreq, exact=exact)
    dev = st.device
    R, N = st.shape
    G = right.shape[0]
    A = index.nchars
    if R not in (4, 5) or N % per_block or per_block % inner:
        raise ValueError(f"candidate_step: bad geometry R={R} N={N} "
                         f"per_block={per_block} inner={inner}")
    _check(st, "st", torch.int32, device=dev)
    _check(valid, "valid", torch.uint8, (N,), dev)
    _check(nch, "nch", torch.uint8, (N // per_block, G), dev)
    for name, t, dt in (("right", right, torch.uint8), ("act", act, torch.uint8),
                        ("u", u, torch.int32), ("lreq", lreq, torch.int32)):
        _check(t, name, dt, (G,), dev)
    _check(index.fwd_blocks, "fwd_blocks", torch.int32, device=dev)
    out = torch.empty((R, N, A), dtype=torch.int32, device=dev)
    valid2 = torch.empty((N, A), dtype=torch.uint8, device=dev)
    far = torch.empty((N,), dtype=torch.uint8, device=dev)
    if N == 0:
        return out, valid2, far
    subw = sub_width(index.has_n)
    CANDIDATE_STEP.launch(
        index.fwd_blocks.data_ptr(), index.fwd_blocks.shape[1], subw,
        index.C.data_ptr(), st.data_ptr(), R, valid.data_ptr(), N, per_block,
        inner, G, nch.data_ptr(), right.data_ptr(), act.data_ptr(),
        u.data_ptr(), lreq.data_ptr(), int(exact), int(index.has_n), A,
        out.data_ptr(), valid2.data_ptr(), far.data_ptr(), _stream(st),
    )
    return out, valid2, far


# ---------------------------------------------------------------------------
# 3. compact
# ---------------------------------------------------------------------------

COMPACT = Kernel(
    "compact", "compact.cu", "genmap_tpu/search/engine.py:168",
    [_P, _P, _I, _L, _I, _I, _P, _P, _P, _P, _P, _I, _P],
)
COMPACT_SHORT_M = 32  # rows up to this long: a lane per slot, rows share a warp
# rows from this long: chunks over many blocks (`chip_ab.py --kernels`'s
# sweep: from M = 4,096 up faster than a warp segment per row at 64 rows
# and at 16 MB of validity per call, bar one case 5 % slower; below it
# slower at 16 MB)
COMPACT_LONG_M = 4096
COMPACT_CHUNK_UNITS = 256  # 16-byte validity units per chunk (csrc/compact.cu)


def compact_chunks(M: int) -> int:
    """Chunks per row of `compact`'s long-row regime for rows of M slots,
    or 0 for the short and middle regimes (a segment of a warp per
    row)."""
    if M < COMPACT_LONG_M:
        return 0
    units = (M + 15) // 16 + 1  # a row off 16-byte alignment spans one more
    return -(-units // COMPACT_CHUNK_UNITS)


def compact_plain(arrays, valid, F: int, count: bool = False):
    """Plain PyTorch version of `compact`."""
    R, rows, M = arrays.shape
    v = valid.bool()
    nvalid = v.sum(dim=-1)
    rank_ = torch.cumsum(v, dim=-1) - 1
    r_i, m_i = torch.nonzero(v & (rank_ < F), as_tuple=True)
    out = torch.zeros((R, rows, F), dtype=arrays.dtype, device=arrays.device)
    out[:, r_i, rank_[r_i, m_i]] = arrays[:, r_i, m_i]
    out_valid = torch.arange(F, device=arrays.device)[None, :] < nvalid[:, None]
    res = (out, out_valid.to(torch.uint8), (nvalid > F).to(torch.uint8))
    return (*res, nvalid.to(torch.int32)) if count else res


def compact(arrays, valid, F: int, count: bool = False):
    """Keep the first F valid entries of every row, in their order.

    arrays: [R, rows, M] int32 operands; valid: [rows, M] uint8.  Returns
    (out [R, rows, F] int32, out_valid [rows, F] uint8, overflow [rows]
    uint8 = more than F valid), and with `count` also each row's valid
    count before the cut (nvalid [rows] int32).  Unused slots are zero.
    The kernel's work split follows M: short rows (M <= 32), middle rows,
    long rows (`compact_chunks`)."""
    if not arrays.is_cuda:
        return compact_plain(arrays, valid, F, count)
    dev = arrays.device
    R, rows, M = arrays.shape
    _check(arrays, "arrays", torch.int32, device=dev)
    _check(valid, "valid", torch.uint8, (rows, M), dev)
    out = torch.empty((R, rows, F), dtype=torch.int32, device=dev)
    out_valid = torch.empty((rows, F), dtype=torch.uint8, device=dev)
    ovf = torch.empty((rows,), dtype=torch.uint8, device=dev)
    nvalid = torch.empty((rows,), dtype=torch.int32, device=dev) if count else None
    res = (out, out_valid, ovf) + ((nvalid,) if count else ())
    if rows == 0:
        return res
    nch = compact_chunks(M)
    chunk_cnt = torch.empty((rows * nch,), dtype=torch.int32, device=dev) if nch else None
    COMPACT.launch(
        arrays.data_ptr(), valid.data_ptr(), R, rows, M, F, out.data_ptr(),
        out_valid.data_ptr(), ovf.data_ptr(),
        None if nvalid is None else nvalid.data_ptr(),
        None if chunk_cnt is None else chunk_cnt.data_ptr(), nch, _stream(arrays),
    )
    return res


# ---------------------------------------------------------------------------
# 4. count_tail
# ---------------------------------------------------------------------------

COUNT_TAIL = Kernel(
    # _count_tail, with ops/rank.py:578 rc_strand_count folded in
    "count_tail", "count_tail.cu", "genmap_tpu/search/engine.py:1334",
    [_P, _P, _L, _I, _I, _P, _P, _I, _U, _P, _I, _P, _P, _P, _P],
)


def count_tail_plain(index, st, valid, cnt, J: int, cap: int, rev_compl: bool,
                     with_exact: bool = False):
    """Plain PyTorch version of `count_tail`."""
    B = cnt.shape[0]
    v = valid.bool().reshape(B, J, -1)
    flo = torch.where(v, rank.u32(st[0]).reshape(B, J, -1), 0)
    size = torch.where(v, rank.u32(st[2]).reshape(B, J, -1), 0)
    if not rev_compl or with_exact:
        rc_in = rank.rc_strand_count(index, flo + size) - rank.rc_strand_count(index, flo)
        fwd = (size - rc_in) & rank.MASK32
    counting = size if rev_compl else fwd
    contrib = torch.where(v, counting.clamp(max=cap), 0)
    hits = contrib.sum(dim=-1).clamp(max=cap)
    valid_j = torch.arange(J, device=cnt.device)[None, :] < cnt[:, None]
    hits = torch.where(valid_j, hits, 0).to(torch.uint16)
    if not with_exact:
        return hits
    em = v & (st[3].reshape(B, J, -1) == 0)

    def esum(x):
        return torch.where(em, x, 0).sum(dim=-1) & rank.MASK32

    return (hits, rank.as_i32(torch.where(valid_j, esum(fwd), 0)),
            rank.as_i32(torch.where(valid_j, esum(size), 0)),
            rank.as_i32(esum(flo)))


def count_tail(index, st, valid, cnt, J: int, cap: int, rev_compl: bool,
               with_exact: bool = False):
    """Per-k-mer frequency of the final extension states.

    st: [R>=3, B*J*Fe] int32 rows flo, rlo, size, err...; valid [B*J*Fe]
    uint8; cnt [B] int32 valid k-mers per block.  Sums min(size, cap) over
    the valid states of each k-mer, saturating at cap; with rev_compl=False
    the reverse-strand rows of each interval (strand rank rows) are
    subtracted first.  Returns hits [B, J] uint16, zero for k-mers >= cnt.

    with_exact (R >= 4) also returns, summed mod 2^32 over the valid states
    with err == 0, exact_size (forward-strand size), exact_size_total (size)
    — both [B, J] int32 holding uint32, zero for k-mers >= cnt — and
    exact_flo (interval start, not masked): (hits, exact_size,
    exact_size_total, exact_flo)."""
    if not st.is_cuda:
        return count_tail_plain(index, st, valid, cnt, J, cap, rev_compl,
                                with_exact)
    dev = st.device
    B = cnt.shape[0]
    N = valid.numel()
    if B * J == 0 or N % (B * J):
        raise ValueError(f"count_tail: {N} states do not split into {B}x{J} k-mers")
    if with_exact and st.shape[0] < 4:
        raise ValueError("count_tail: with_exact needs the err row (R >= 4)")
    Fe = N // (B * J)
    _check(st, "st", torch.int32, device=dev)
    _check(valid, "valid", torch.uint8, device=dev)
    _check(cnt, "cnt", torch.int32, (B,), dev)
    _check(index.strand_blocks, "strand_blocks", torch.int32, device=dev)
    hits = torch.empty((B, J), dtype=torch.uint16, device=dev)
    ex = [torch.empty((B, J), dtype=torch.int32, device=dev)
          for _ in range(3 if with_exact else 0)]
    ptrs = [t.data_ptr() for t in ex] or [None, None, None]
    COUNT_TAIL.launch(
        st.data_ptr(), valid.data_ptr(), B * J, Fe, J, cnt.data_ptr(),
        index.strand_blocks.data_ptr(), int(rev_compl), int(cap),
        hits.data_ptr(), int(with_exact), *ptrs, _stream(st),
    )
    return (hits, *ex) if with_exact else hits


# ---------------------------------------------------------------------------
# 5. probe_mass
# ---------------------------------------------------------------------------

PROBE_MASS = Kernel(
    # the probe branch of block_mapper_impl (mass_p, nwin, skip test), the
    # engine's sum of the masses over index parts, and (entry _reduced) the
    # part mesh's decision on the masses summed over devices
    # (genmap_tpu/parallel/partmesh.py:321-325)
    "probe_mass", "probe_mass.cu", "genmap_tpu/search/engine.py:1251",
    [_P, _P, _L, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    entries={"_reduced": [_P, _L, _I, _P, _P, _P, _P]},
)
PROBE_MAX_PLANS = 16


def probe_mass_plain(st, valid, ovf, needles, thr, has_n: bool,
                     with_mass: bool = False, acc=None, last: bool = True):
    """Plain PyTorch version of `probe_mass`."""
    P = thr.shape[0]
    if st is None:
        mass = acc[:, :P].clamp(max=rank.MASK32)
        skip = ((mass <= thr.to(torch.int64)[None, :]).all(dim=-1)
                & (acc[:, P] == 0)).to(torch.uint8)
        return (skip, rank.as_i32(mass)) if with_mass else skip
    _R, B, F = st.shape
    plan = st[4].to(torch.int64)
    inplan = valid.bool() & (plan >= 0) & (plan < P)
    mass = torch.zeros((B, P), dtype=torch.int64, device=st.device).scatter_add_(
        1, plan.clamp(0, P - 1), torch.where(inplan, rank.u32(st[2]), 0)
    ).clamp(max=rank.MASK32)
    if has_n:
        nwin = (needles == 4).any(dim=-1)
    else:
        nwin = torch.zeros(B, dtype=torch.bool, device=st.device)
    bad = ovf.bool() | nwin
    if acc is not None:
        mass = (mass + acc[:, :P]).clamp(max=rank.MASK32)
        bad = bad | (acc[:, P] != 0)
    if not last:
        return torch.cat([mass, bad.to(torch.int64)[:, None]], dim=1)
    skip = ((mass <= thr.to(torch.int64)[None, :]).all(dim=-1) & ~bad).to(torch.uint8)
    if not with_mass:
        return skip
    return skip, rank.as_i32(mass), nwin.to(torch.uint8)


def probe_mass(st, valid, ovf, needles, thr, has_n: bool, with_mass: bool = False,
               acc=None, last: bool = True):
    """The unique-infix probe's skip decision of every block.

    st: [5, B, F] int32 infix survivor states (size row 2, plan id row 4);
    valid [B, F] uint8; ovf [B] uint8 (capacity or far overflow of the
    scan); needles [B, Ln] uint8; thr [P] int32 per-plan mass thresholds
    (`probe_thresholds`).  A block is skipped when every plan's summed
    survivor size is <= thr[p], it did not overflow and (Dna5) its needle
    window holds no N.  Masses are summed in 64 bits and saturate at
    2^32 - 1.  Returns skip [B] uint8, or with with_mass (skip, mass_p [B, P]
    int32 holding uint32, nwin [B] uint8).

    Multi-part indexes: `acc` is the running [B, P + 1] int64 sum of the
    earlier parts (per-plan masses, saturated at 2^32 - 1, and in column P
    their overflow and N-window flags ORed); a launch with last=False adds
    this part and returns the new accumulator (a new tensor; `acc` is not
    written), the launch for the last part (last=True) decides on the sum.
    With one part (acc None, last True) the launch is the plain skip test.

    Part mesh: with st (and valid, ovf, needles) None, the launch decides
    from `acc` alone — the parts' accumulators summed over devices (each
    mass already saturated, so the int64 sum cannot wrap): masses saturate
    at 2^32 - 1 and a non-zero flag column marks the block.  Returns skip,
    or with with_mass (skip, mass_p)."""
    if st is None:
        return _probe_mass_reduced(acc, thr, with_mass)
    if not st.is_cuda:
        return probe_mass_plain(st, valid, ovf, needles, thr, has_n, with_mass,
                                acc, last)
    dev = st.device
    R, B, F = st.shape
    P = thr.shape[0]
    if R != 5 or not 1 <= P <= PROBE_MAX_PLANS:
        raise ValueError(f"probe_mass: bad geometry R={R} P={P}")
    if with_mass and not last:
        raise ValueError("probe_mass: with_mass needs last=True")
    Ln = needles.shape[1]
    _check(st, "st", torch.int32, device=dev)
    _check(valid, "valid", torch.uint8, (B, F), dev)
    _check(ovf, "ovf", torch.uint8, (B,), dev)
    _check(needles, "needles", torch.uint8, (B, Ln), dev)
    _check(thr, "thr", torch.int32, (P,), dev)
    if acc is not None:
        _check(acc, "acc", torch.int64, (B, P + 1), dev)
    skip = torch.empty((B,), dtype=torch.uint8, device=dev) if last else None
    acc_out = None if last else torch.empty((B, P + 1), dtype=torch.int64, device=dev)
    mass = torch.empty((B, P), dtype=torch.int32, device=dev) if with_mass else None
    nwin = torch.empty((B,), dtype=torch.uint8, device=dev) if with_mass else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    PROBE_MASS.launch(
        st.data_ptr(), valid.data_ptr(), B, F, P, ovf.data_ptr(),
        needles.data_ptr(), Ln, int(has_n), thr.data_ptr(), ptr(acc),
        ptr(acc_out), ptr(skip), ptr(mass), ptr(nwin), _stream(st),
    )
    if not last:
        return acc_out
    return (skip, mass, nwin) if with_mass else skip


def _probe_mass_reduced(acc, thr, with_mass: bool):
    if not acc.is_cuda:
        return probe_mass_plain(None, None, None, None, thr, False, with_mass, acc)
    dev = acc.device
    P = thr.shape[0]
    B = acc.shape[0]
    if not 1 <= P <= PROBE_MAX_PLANS:
        raise ValueError(f"probe_mass: bad plan count P={P}")
    _check(acc, "acc", torch.int64, (B, P + 1), dev)
    _check(thr, "thr", torch.int32, (P,), dev)
    skip = torch.empty((B,), dtype=torch.uint8, device=dev)
    mass = torch.empty((B, P), dtype=torch.int32, device=dev) if with_mass else None
    PROBE_MASS.launch(acc.data_ptr(), B, P, thr.data_ptr(), skip.data_ptr(),
                      None if mass is None else mass.data_ptr(), _stream(acc),
                      entry="_reduced")
    return (skip, mass) if with_mass else skip


# ---------------------------------------------------------------------------
# 6. locate
# ---------------------------------------------------------------------------

LOCATE = Kernel(
    # locate, with ops/rank.py:589 bwt_char folded in
    "locate", "locate.cu", "genmap_tpu/ops/rank.py:617",
    [_P, _I, _I, _P, _P, _P, _P, _L, _P, _P, _L, _I, _P, _P, _P],
)


def locate_plain(index, pos, valid):
    """Plain PyTorch version of `locate`."""
    subw = sub_width(index.has_n)
    C = rank.u32(index.C)
    p = rank.u32(pos)
    steps = torch.zeros_like(p)
    done = ~valid.bool()
    for _ in range(index.sampling):
        irows = rank.u32(index.ind_blocks[p >> 7])
        off = p & 127
        ibit = (irows[:, 1:].gather(1, (off >> 5)[:, None])[:, 0] >> (off & 31)) & 1
        now_done = (ibit == 1) & ~done
        sub = index.fwd_blocks[p >> 9, :subw]
        code, _sbit = rank.bwt_char(sub, p, index.has_n)
        occ, _sent = rank._occ_sub(sub, p, index.has_n)
        p_next = (C[code] + occ.gather(1, code[:, None])[:, 0]) & rank.MASK32
        stay = done | now_done
        p = torch.where(stay, p, p_next)
        steps = torch.where(stay, steps, steps + 1)
        done = stay
    irows = rank.u32(index.ind_blocks[p >> 7])
    bmask = rank._bit_masks(p & 127, rank.BVWORDS)
    irank = (irows[:, 0] + rank._popcount_sum(irows[:, 1:] & bmask)) & rank.MASK32
    vidx = torch.where(valid.bool(), irank, 0).clamp(max=index.sa_i1.shape[0] - 1)
    i1 = index.sa_i1[vidx]
    i2 = rank.as_i32(rank.u32(index.sa_i2[vidx]) + steps)
    return i1, i2


def locate(index, pos, valid):
    """(seq, pos) of SA rows by LF walks of at most `index.sampling` steps
    to a sampled row.

    pos: [N] int32 (uint32 SA rows of the part); valid [N] uint8 (invalid
    rows read sample 0 and take no step).  Needs a full (non-light) index.
    Returns (i1, i2) [N] int32 holding uint32: the part-local sequence
    number (rc half after all forward sequences) and the position in it."""
    if index.sa_i1.shape[0] == 0:
        raise RuntimeError("locate needs the SA samples: upload the index "
                           "with light=False")
    if not pos.is_cuda:
        return locate_plain(index, pos, valid)
    dev = pos.device
    N = pos.shape[0]
    _check(pos, "pos", torch.int32, (N,), dev)
    _check(valid, "valid", torch.uint8, (N,), dev)
    for name in ("fwd_blocks", "C", "ind_blocks", "sa_i1", "sa_i2"):
        _check(getattr(index, name), name, torch.int32, device=dev)
    if index.C.numel() < 6:
        raise ValueError("locate: C needs its 6 entries (C[5] is n_total)")
    # the kernel reads sub-rows as 16- or 8-byte vectors
    if index.fwd_blocks.shape[1] % 2 or index.fwd_blocks.data_ptr() % 8:
        raise ValueError(f"locate: rank rows of width {index.fwd_blocks.shape[1]} at "
                         f"{index.fwd_blocks.data_ptr():#x}: needs an even width and "
                         f"8-byte alignment")
    i1 = torch.empty((N,), dtype=torch.int32, device=dev)
    i2 = torch.empty((N,), dtype=torch.int32, device=dev)
    LOCATE.launch(
        index.fwd_blocks.data_ptr(), index.fwd_blocks.shape[1],
        int(index.has_n), index.C.data_ptr(), index.ind_blocks.data_ptr(),
        index.sa_i1.data_ptr(), index.sa_i2.data_ptr(), index.sa_i1.shape[0],
        pos.data_ptr(), valid.data_ptr(), N, index.sampling, i1.data_ptr(),
        i2.data_ptr(), _stream(pos),
    )
    return i1, i2


# ---------------------------------------------------------------------------
# 7. dimer_step
# ---------------------------------------------------------------------------

DIMER_STEP = Kernel(
    # _candidate_step_fused, with ops/rank.py:397-570 _dimer_occ, _dimer_tail,
    # extend_dimer_fast and extend_dimer folded in
    "dimer_step", "dimer_step.cu", "genmap_tpu/search/engine.py:262",
    [_P, _I, _P, _P, _P, _I, _P, _L, _L, _L, _I, _P, _P, _P, _P, _P, _P, _P,
     _P, _I, _I, _I, _I, _P, _P, _P, _P],
)
DIMER_SLOTS = 16


def dimer_step_plain(index, st, valid, *, per_block, inner, consume, right,
                     u_mid, u_end, l_mid, l_end, nchA, nchB, exact,
                     with_mono, with_pass):
    """Plain PyTorch version of `dimer_step` (same arguments, same results
    on every slot the kernel's contract defines).  Only valid consuming
    states are computed: it fills the undefined slots with zeros (invalid
    states) and copies (passthrough states)."""
    R, N = st.shape
    A = index.nchars
    G = right.shape[0]
    dev = st.device
    blk, g = _state_groups(st, per_block, inner, G)
    v = valid.bool()
    cons = consume.to(torch.int64)[g]
    slot = torch.arange(DIMER_SLOTS, dtype=torch.int64, device=dev)[None, :]
    passing = (cons == 0) if with_pass else torch.zeros_like(v)

    out = torch.zeros((R, N, DIMER_SLOTS), dtype=torch.int32, device=dev)
    idle = torch.nonzero(passing).squeeze(1)
    out[:, idle] = st[:, idle, None]
    valid2 = passing[:, None] & v[:, None] & (slot == 0)
    far = torch.zeros(N, dtype=torch.bool, device=dev)

    w = torch.nonzero(v & ~passing).squeeze(1)
    g, blk, cons = g[w], blk[w], cons[w]
    flo, rlo, size = (rank.u32(st[r, w]) for r in range(3))
    rb = right.bool()[g][:, None]
    mlo = torch.where(rb[:, 0], rlo, flo)
    olo = torch.where(rb[:, 0], flo, rlo)
    ext = rank.extend_dimer if exact else rank.extend_dimer_fast
    (d_mlo, d_size, d_olo), (m_mlo, m_size, m_olo), far_w = ext(index, mlo, size, olo)

    def bound(t):
        return t.to(torch.int64)[g][:, None]

    a = nchA.to(torch.int64)[blk, g][:, None]
    b = nchB.to(torch.int64)[blk, g][:, None]
    err = st[3, w].to(torch.int64)[:, None]
    # dimer candidates: a left step consumes (c2, c1), a right step their
    # complements
    c2, c1 = slot >> 2, slot & 3
    first = torch.where(rb, 3 - c2, c2)
    second = torch.where(rb, 3 - c1, c1)
    err_mid = err + ((first != a) | (a >= 4)).to(torch.int64)
    err2 = err_mid + ((second != b) | (b >= 4)).to(torch.int64)
    ok = ((err_mid <= bound(u_mid)) & (err_mid >= bound(l_mid))
          & (err2 <= bound(u_end)) & (err2 >= bound(l_end)) & (d_size > 0))
    nflo = torch.where(rb, d_olo, d_mlo)
    nrlo = torch.where(rb, d_mlo, d_olo)
    nsz = d_size
    if with_mono:  # mono candidates in slots 0..A-1, comp-permuted on right steps
        perm = torch.tensor(rank.comp_perm(A), device=dev)
        mm = torch.where(rb, m_mlo[:, perm], m_mlo)
        ms = torch.where(rb, m_size[:, perm], m_size)
        mo = torch.where(rb, m_olo[:, perm], m_olo)
        err_m = err + ((slot[:, :A] != a) | (a >= 4)).to(torch.int64)
        ok_m = (err_m <= bound(u_end)) & (err_m >= bound(l_end)) & (ms > 0)

        def pad(x):
            return Fn.pad(x, (0, DIMER_SLOTS - A))

        mono = (cons != 2)[:, None]
        nflo = torch.where(mono, pad(torch.where(rb, mo, mm)), nflo)
        nrlo = torch.where(mono, pad(torch.where(rb, mm, mo)), nrlo)
        nsz = torch.where(mono, pad(ms), nsz)
        err2 = torch.where(mono, pad(err_m), err2)
        ok = torch.where(mono, pad(ok_m), ok)
    outs = [nflo, nrlo, nsz, err2]
    if R == 5:
        outs.append(g[:, None].expand(-1, DIMER_SLOTS))
    out[:, w] = rank.as_i32(torch.stack(outs))
    valid2[w] = ok & ~far_w[:, None]
    far[w] = far_w
    return out, valid2.to(torch.uint8), far.to(torch.uint8)


def dimer_step_defined(st, valid, consume, per_block: int, inner: int, A: int,
                       with_mono: bool, with_pass: bool) -> torch.Tensor:
    """[N, 16] bool: the slots of `dimer_step`'s out that its contract
    defines (all 16 of a valid dimer step, 0..A-1 of a valid mono step,
    slot 0 of a valid passthrough)."""
    _blk, g = _state_groups(st, per_block, inner, consume.shape[0])
    cons = consume.to(torch.int64)[g]
    passing = (cons == 0) if with_pass else torch.zeros_like(cons, dtype=torch.bool)
    mono = ~passing & (cons != 2) if with_mono else torch.zeros_like(passing)
    slot = torch.arange(DIMER_SLOTS, device=st.device)[None, :]
    width = torch.where(passing, 1, torch.where(mono, A, DIMER_SLOTS))
    return valid.bool()[:, None] & (slot < width[:, None])


def dimer_step_view(res, *, index, st, valid, consume, per_block: int, inner: int,
                    with_mono: bool, with_pass: bool, **_):
    """What a consumer can read of a `dimer_step` result `res` (called with
    the step's own arguments): out with the undefined slots zeroed, valid2,
    far, and the engine's compaction of out by valid2 (rows of `inner`
    states, `compact_plain`).  Two results agree under the contract when
    their views are equal."""
    out, valid2, far = res
    R, N, S = out.shape
    defined = dimer_step_defined(st, valid, consume, per_block, inner, index.nchars,
                                 with_mono, with_pass)
    rows = N // inner
    kept = compact_plain(out.reshape(R, rows, inner * S),
                         valid2.reshape(rows, inner * S), inner)
    return (torch.where(defined[None], out, 0), valid2, far, *kept)


def dimer_step(index, st, valid, *, per_block: int, inner: int, consume,
               right, u_mid, u_end, l_mid, l_end, nchA, nchB, exact: bool,
               with_mono: bool, with_pass: bool):
    """One search step of N states on the dimer rank rows.

    st / valid / per_block / inner and the groups: as in `candidate_step`.
    Per group: consume [G] uint8 (2: a dimer step consuming nchA then nchB,
    1: a mono step consuming nchA, 0: passthrough), right [G] uint8, and the
    cumulative error bounds after the first char (u_mid, l_mid) and after
    the step (u_end, l_end), [G] int32; nchA / nchB [N // per_block, G]
    uint8.  `with_mono` / `with_pass` say whether consume 1 / 0 occur; a
    state takes the dimer path unless they do.  `exact` reads one dimer row
    per bound; otherwise one paired row, raising `far` for intervals wider
    than its 256-symbol window; both raise `far` on flagged
    (sentinel/N-adjacent) sub-blocks.

    Returns (out [R, N, 16] int32, valid2 [N, 16] uint8, far [N] uint8):
    slot t of a dimer step is the state extended by the dimer of code t
    (c2*4 + c1, prepended c1c2), slots 0..A-1 of a mono step by one
    character, slot 0 of a passthrough the state itself; err counts the
    mismatching chars (N mismatches every candidate), valid2 prunes by the
    bounds, empty intervals and far.

    Contract: valid2 and far are written for every state; out[:, i, :] is
    defined where state i is valid and consumes (all 16 slots on a dimer
    step, slots 0..A-1 on a mono step), out[:, i, 0] where it is valid and
    passes through (it holds the state), and every other slot of out is
    undefined (the kernel leaves it as allocated; `dimer_step_defined`).
    compact reads only slots whose valid2 is 1, and `far` is read whole.
    Compare two results with `dimer_step_view`, never whole."""
    if not st.is_cuda:
        return dimer_step_plain(index, st, valid, per_block=per_block,
                                inner=inner, consume=consume, right=right,
                                u_mid=u_mid, u_end=u_end, l_mid=l_mid,
                                l_end=l_end, nchA=nchA, nchB=nchB, exact=exact,
                                with_mono=with_mono, with_pass=with_pass)
    dev = st.device
    R, N = st.shape
    G = right.shape[0]
    if R not in (4, 5) or N % per_block or per_block % inner:
        raise ValueError(f"dimer_step: bad geometry R={R} N={N} "
                         f"per_block={per_block} inner={inner}")
    if not index.has_dimer:
        raise ValueError("dimer_step: the index part has no dimer rows")
    _check(st, "st", torch.int32, device=dev)
    _check(valid, "valid", torch.uint8, (N,), dev)
    for name, t in (("nchA", nchA), ("nchB", nchB)):
        _check(t, name, torch.uint8, (N // per_block, G), dev)
    for name, t, dt in (("consume", consume, torch.uint8),
                        ("right", right, torch.uint8),
                        ("u_mid", u_mid, torch.int32), ("u_end", u_end, torch.int32),
                        ("l_mid", l_mid, torch.int32), ("l_end", l_end, torch.int32)):
        _check(t, name, dt, (G,), dev)
    _check(index.dimer_blocks, "dimer_blocks", torch.int32,
           (index.dimer_blocks.shape[0], 2 * D_WIDTH), dev)
    out = torch.empty((R, N, DIMER_SLOTS), dtype=torch.int32, device=dev)
    valid2 = torch.empty((N, DIMER_SLOTS), dtype=torch.uint8, device=dev)
    far = torch.empty((N,), dtype=torch.uint8, device=dev)
    if N == 0:
        return out, valid2, far
    DIMER_STEP.launch(
        index.dimer_blocks.data_ptr(), index.dimer_blocks.shape[1],
        index.C2.data_ptr(), index.C.data_ptr(), st.data_ptr(), R,
        valid.data_ptr(), N, per_block, inner, G, consume.data_ptr(),
        right.data_ptr(), u_mid.data_ptr(), u_end.data_ptr(), l_mid.data_ptr(),
        l_end.data_ptr(), nchA.data_ptr(), nchB.data_ptr(), int(exact),
        int(with_mono), int(with_pass), index.nchars, out.data_ptr(),
        valid2.data_ptr(), far.data_ptr(), _stream(st),
    )
    return out, valid2, far


# ---------------------------------------------------------------------------
# 8. seed_lookup
# ---------------------------------------------------------------------------

SEED_LOOKUP = Kernel(
    "seed_lookup", "seed_lookup.cu", "genmap_tpu/search/engine.py:529",
    [_P, _P, _P, _I, _P, _I, _I, _U, _U, _I, _I, _P, _P, _P],
)


def seed_lookup_plain(index, needles, a_pos, t_seed: int, Fp: int, n_total: int):
    """Plain PyTorch version of `seed_lookup`."""
    B = needles.shape[0]
    P = a_pos.shape[0]
    dev = needles.device
    st = torch.zeros((5, B, Fp), dtype=torch.int32, device=dev)
    st[4] = (torch.arange(Fp, dtype=torch.int32, device=dev) % P)[None, :]
    valid = torch.zeros((B, Fp), dtype=torch.uint8, device=dev)
    if t_seed == 0:
        st[2, :, :P] = rank.as_i32(torch.tensor(n_total, dtype=torch.int64))
        valid[:, :P] = 1
        return st, valid
    off = rank.seed_level_offset(t_seed)
    pw = 4 ** torch.arange(t_seed - 1, -1, -1, dtype=torch.int64, device=dev)
    for p, a_p in enumerate(a_pos.tolist()):
        w = needles[:, a_p : a_p + t_seed].to(torch.int64)  # [B, t_seed]
        okw = (w < 4).all(dim=-1)
        wc = w.clamp(max=3)
        code = off + (wc * pw).sum(dim=-1)
        rc_code = off + ((3 - wc) * pw.flip(0)).sum(dim=-1)
        size = index.seed_size[code]
        st[0, :, p] = index.seed_mlo[code]
        st[1, :, p] = index.seed_mlo[rc_code]
        st[2, :, p] = size
        valid[:, p] = (okw & (size != 0)).to(torch.uint8)
    return st, valid


def seed_lookup(index, needles, a_pos, t_seed: int, Fp: int, n_total: int):
    """The pooled infix scan's starting states of every block.

    needles [B, Ln] uint8; a_pos [P] int32: where plan p's first t_seed
    exact steps read their needle window.  Slot p < P holds plan p's state
    after those steps, looked up in the index's seed tables (seed_mlo and
    seed_size of the window's code, seed_mlo of its reverse complement's),
    invalid where the window holds an N or the interval is empty; with
    t_seed = 0 it holds the whole index (size n_total, the part's symbols).  Slots P..Fp-1 are
    empty.  Returns (st [5, B, Fp] int32 rows flo, rlo, size (uint32 bits),
    err = 0, plan id = slot % P; valid [B, Fp] uint8).  Every slot is
    written."""
    if not needles.is_cuda:
        return seed_lookup_plain(index, needles, a_pos, t_seed, Fp, n_total)
    dev = needles.device
    B, Ln = needles.shape
    P = a_pos.shape[0]
    if not 1 <= P <= Fp or (t_seed and not index.has_seed) or t_seed > 15:
        raise ValueError(f"seed_lookup: bad geometry P={P} Fp={Fp} t_seed={t_seed}")
    _check(needles, "needles", torch.uint8, device=dev)
    _check(a_pos, "a_pos", torch.int32, (P,), dev)
    _check(index.seed_mlo, "seed_mlo", torch.int32, device=dev)
    _check(index.seed_size, "seed_size", torch.int32, device=dev)
    st = torch.empty((5, B, Fp), dtype=torch.int32, device=dev)
    valid = torch.empty((B, Fp), dtype=torch.uint8, device=dev)
    if B == 0:
        return st, valid
    SEED_LOOKUP.launch(
        index.seed_mlo.data_ptr(), index.seed_size.data_ptr(), needles.data_ptr(),
        Ln, a_pos.data_ptr(), P, t_seed, rank.seed_level_offset(t_seed),
        int(n_total) & 0xFFFFFFFF, B, Fp, st.data_ptr(), valid.data_ptr(),
        _stream(needles),
    )
    return st, valid


# ---------------------------------------------------------------------------
# 9. gather_states
# ---------------------------------------------------------------------------

GATHER_STATES = Kernel(
    # sl() of _run_tier_split (the take + cut or pad of phase-A states)
    "gather_states", "gather_states.cu", "genmap_tpu/engine/mappability.py:1477",
    [_P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P],
)


def gather_states_plain(st, valid, ridx, n: int, Fe: int):
    """Plain PyTorch version of `gather_states`."""
    r = ridx.to(torch.int64)
    Fc = st.shape[2]
    x, v = st[:, r], valid[r]
    if Fc >= Fe:
        x, v = x[..., :Fe], v[:, :Fe]
    else:
        x, v = Fn.pad(x, (0, Fe - Fc)), Fn.pad(v, (0, Fe - Fc))
    live = torch.arange(r.shape[0], device=st.device) < n
    return x.contiguous(), (v.bool() & live[:, None]).to(torch.uint8)


def gather_states(st, valid, ridx, n: int, Fe: int):
    """Rows `ridx` of the phase-A survivor states, cut or zero-padded to Fe
    slots.

    st [4, B, Fc] int32 (flo, rlo, size, err); valid [B, Fc] uint8; ridx
    [npad] int32 row ids (zero-padded past the first n).  Returns (st2 [4,
    npad, Fe], valid2 [npad, Fe]): each output row copies the first
    min(Fc, Fe) slots of its row and zeros the rest; rows >= n are
    invalid."""
    if not st.is_cuda:
        return gather_states_plain(st, valid, ridx, n, Fe)
    dev = st.device
    R, B, Fc = st.shape
    npad = ridx.shape[0]
    if R != 4 or not 0 <= n <= npad:
        raise ValueError(f"gather_states: bad geometry R={R} n={n} npad={npad}")
    _check(st, "st", torch.int32, device=dev)
    _check(valid, "valid", torch.uint8, (B, Fc), dev)
    _check(ridx, "ridx", torch.int32, (npad,), dev)
    out = torch.empty((4, npad, Fe), dtype=torch.int32, device=dev)
    out_valid = torch.empty((npad, Fe), dtype=torch.uint8, device=dev)
    if npad * Fe == 0:
        return out, out_valid
    GATHER_STATES.launch(
        st.data_ptr(), valid.data_ptr(), B, Fc, ridx.data_ptr(), npad, n, Fe,
        out.data_ptr(), out_valid.data_ptr(), _stream(st),
    )
    return out, out_valid


# ---------------------------------------------------------------------------
# 10. row_gather
# ---------------------------------------------------------------------------

ROW_GATHER = Kernel(
    # the repo's one Pallas kernel: pallas_dma_sum (:106) with its body
    # dma_kernel (:81), and (entry _chain) its baseline xla_chain (:72)
    "row_gather", "row_gather.cu", "benchmarks/pallas_experiments.py:81", None,
    entries={"_sum": [_P, _I, _I, _P, _L, _I, _I, _P, _P],
             "_chain": [_P, _I, _I, _P, _L, _I, _I, _I, _P, _P],
             "_sum_bulk": [_P, _I, _I, _P, _L, _I, _P, _P],
             "_chain_bulk": [_P, _I, _I, _P, _L, _I, _I, _P, _P],
             "_bulk_ok": [_P, _I, _I]},
)
# threads per row of the word kernels (1, 4, 8, 32), or 0: bulk copies of
# whole rows into shared memory (csrc/row_gather.cu)
ROW_GATHER_LANES = (0, 1, 4, 8, 32)
# The default design, the same for the sum and the chain (the fastest that
# `chip_ab.py --kernels` and the smoke's sweep measured on the H100, but for
# the 512 B sum above L2, 2.9-3.5 % behind lanes 8; csrc/row_gather.cu's
# header, PERF.md §6, PR 12):
# fewer than ROW_GATHER_SMALL ids are launch-bound, and 32 lanes measured
# fastest there (the harness's 4,096-id sum); tables above
# ROW_GATHER_L2_BYTES (measured at 256 MiB and 4 GiB; at or below it, at
# 16 and 20 MB) take the bulk copies where they apply, else the word kernel
# of ROW_GATHER_WORD_LANES[above][the nearest measured row width].
ROW_GATHER_WORD_LANES = {False: {208: 8, 416: 4, 512: 8},
                         True: {208: 8, 416: 32, 512: 8}}
ROW_GATHER_L2_BYTES = 32 << 20
ROW_GATHER_SMALL = 1 << 14


def row_gather_bulk(table, kind: str) -> bool:
    """Whether the bulk copies run for `table` in `row_gather_sum` (kind
    "sum") or `row_gather_chain` ("chain"), as the kernel's library decides
    it (entry _bulk_ok: rows of whole 16-byte units at a 16-byte aligned
    base whose stages or slots fit the shared memory).  False on the CPU,
    where no kernel runs."""
    if not table.is_cuda:
        return False
    return bool(ROW_GATHER.fn("_bulk_ok")(table.data_ptr(), table.shape[1],
                                          int(kind == "chain")))


def row_gather_word_lanes(table) -> int:
    """The word kernel's lanes for `table` (ROW_GATHER_WORD_LANES)."""
    rule = ROW_GATHER_WORD_LANES[table.numel() * 4 > ROW_GATHER_L2_BYTES]
    return rule[min(rule, key=lambda w: (abs(w - 4 * table.shape[1]), w))]


def row_gather_lanes(table, n: int) -> int:
    """The lanes that `row_gather_sum` and `row_gather_chain` take by
    default for n ids of `table`: 32 below ROW_GATHER_SMALL ids, 0 (the
    bulk copies where they apply) above ROW_GATHER_L2_BYTES, else
    `row_gather_word_lanes`."""
    if n < ROW_GATHER_SMALL:
        return 32
    if table.numel() * 4 > ROW_GATHER_L2_BYTES:
        return 0
    return row_gather_word_lanes(table)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 value of the low 32 bits of an int64 tensor (two's
    complement: 2^32 is subtracted from values >= 2^31)."""
    x = x & rank.MASK32
    return (x - (x >= 2**31).to(torch.int64) * 2**32).to(torch.int32)


def row_gather_sum_plain(table, idx, chunk: int = 128, lanes: int | None = None,
                         blocks: int = 0):
    """Plain PyTorch version of `row_gather_sum` (`lanes` and `blocks` only
    shape the kernel's launch)."""
    n_used = idx.shape[0] // chunk * chunk
    rows = torch.index_select(table, 0, idx[:n_used])
    return _wrap_i32(rows.sum(dtype=torch.int64))


def row_gather_chain_steps(table, idx, steps: int):
    """The chains' ids before each step and after the last (steps + 1
    tensors): c <- (the int32-wrapped sum of row c) floor-mod NR."""
    NR = table.shape[0]
    ids = [idx]
    for _ in range(steps):
        s = _wrap_i32(torch.index_select(table, 0, ids[-1]).sum(dim=-1, dtype=torch.int64))
        ids.append(torch.remainder(s.to(torch.int64), NR).to(torch.int32))
    return ids


def row_gather_chain_plain(table, idx, steps: int = 8, lanes: int | None = None,
                           blocks: int = 0):
    """Plain PyTorch version of `row_gather_chain`."""
    return _wrap_i32(row_gather_chain_steps(table, idx, steps)[-1].sum(dtype=torch.int64))


def _row_gather_check(table, idx, lanes: int, blocks: int) -> None:
    if table.dim() != 2 or idx.dim() != 1 or blocks < 0:
        raise ValueError(f"row_gather: bad geometry table {tuple(table.shape)} "
                         f"idx {tuple(idx.shape)} blocks {blocks}")
    if lanes not in ROW_GATHER_LANES:
        raise ValueError(f"row_gather: lanes must be one of {ROW_GATHER_LANES}, got {lanes}")
    if not 0 < table.shape[0] < 2**31 or table.shape[1] <= 0:
        raise ValueError(f"row_gather: table of {tuple(table.shape)} rows")
    _check(table, "table", torch.int32)
    _check(idx, "idx", torch.int32, device=table.device)


def row_gather_sum(table, idx, chunk: int = 128, lanes: int | None = None,
                   blocks: int = 0):
    """The wrapped int32 sum of every element of rows idx[:n_used] of
    `table`, n_used = (ND // chunk) * chunk (the harness's fori_loop over
    whole chunks drops the tail ids).

    table [NR, W] int32; idx [ND] int32 row ids in [0, NR).  `lanes` (1, 4,
    8 or 32) threads read one row, or (0) the copy engine moves whole rows
    into shared memory (where `row_gather_bulk` allows it; else the word
    kernel of `row_gather_word_lanes` runs); None: `row_gather_lanes`'s
    pick.  `blocks` sets the grid and so the rows in flight (0: one id per
    row group, capped at the blocks the card holds at once).  Returns a 0-d
    int32 tensor on the table's device, with no host sync."""
    if chunk <= 0:
        raise ValueError(f"row_gather_sum: chunk must be positive, got {chunk}")
    if lanes is None and table.dim() == 2 and idx.dim() == 1:
        lanes = row_gather_lanes(table, idx.shape[0] // chunk * chunk)
    _row_gather_check(table, idx, lanes, blocks)
    if not table.is_cuda:
        return row_gather_sum_plain(table, idx, chunk)
    out = torch.zeros((), dtype=torch.int32, device=table.device)
    n_used = idx.shape[0] // chunk * chunk
    if n_used == 0:
        return out
    NR, W = table.shape
    if lanes == 0 and not row_gather_bulk(table, "sum"):
        lanes = row_gather_word_lanes(table)
    if lanes == 0:
        ROW_GATHER.launch(table.data_ptr(), NR, W, idx.data_ptr(), n_used, blocks,
                          out.data_ptr(), _stream(table), entry="_sum_bulk")
    else:
        ROW_GATHER.launch(table.data_ptr(), NR, W, idx.data_ptr(), n_used, lanes,
                          blocks, out.data_ptr(), _stream(table), entry="_sum")
    return out


def row_gather_chain(table, idx, steps: int = 8, lanes: int | None = None,
                     blocks: int = 0):
    """`steps` dependent row reads from each id: c <- (the int32-wrapped
    sum of row c) floor-mod NR; returns the wrapped int32 sum of the last
    ids (a 0-d int32 tensor, no host sync).  Arguments as in
    `row_gather_sum`; the ids must lie in [0, NR)."""
    if steps < 0:
        raise ValueError(f"row_gather_chain: steps must be >= 0, got {steps}")
    if lanes is None and table.dim() == 2 and idx.dim() == 1:
        lanes = row_gather_lanes(table, idx.shape[0])
    _row_gather_check(table, idx, lanes, blocks)
    if not table.is_cuda:
        return row_gather_chain_plain(table, idx, steps)
    out = torch.zeros((), dtype=torch.int32, device=table.device)
    N = idx.shape[0]
    if N == 0:
        return out
    NR, W = table.shape
    if lanes == 0 and not row_gather_bulk(table, "chain"):
        lanes = row_gather_word_lanes(table)
    if lanes == 0:
        ROW_GATHER.launch(table.data_ptr(), NR, W, idx.data_ptr(), N, steps, blocks,
                          out.data_ptr(), _stream(table), entry="_chain_bulk")
    else:
        ROW_GATHER.launch(table.data_ptr(), NR, W, idx.data_ptr(), N, steps, lanes,
                          blocks, out.data_ptr(), _stream(table), entry="_chain")
    return out


# ---------------------------------------------------------------------------
# 11. seed_build
# ---------------------------------------------------------------------------

SEED_BUILD = Kernel(
    "seed_build", "seed_build.cu", "genmap_tpu/ops/rank.py:345", None,
    entries={"_shallow": [_P, _I, _I, _I, _P, _U, _I, _P, _P, _P],
             "_level": [_P, _I, _I, _I, _P, _I, _P, _P, _P],
             "_depth": []},
)
SEED_T_MAX = 15  # the deepest table the kernels index (csrc/seed_build.cu)


def seed_build_plain(index, t0: int):
    """Plain PyTorch version of `seed_build`: level by level, the exact
    candidate step of every string of the level (`candidate_step_plain`,
    never the CUDA kernel), in chunks that bound its memory."""
    dev = index.device
    chunk = (1 << 22) if dev.type == "cuda" else (1 << 15)
    zeros = torch.zeros(1, dtype=torch.int32, device=dev)
    ones = torch.ones(1, dtype=torch.uint8, device=dev)
    big = torch.full((1,), 1 << 20, dtype=torch.int32, device=dev)
    mlo = torch.zeros(1, dtype=torch.int32, device=dev)
    size = rank.as_i32(torch.full((1,), index.n_total, dtype=torch.int64, device=dev))
    mlo_parts, size_parts = [mlo], [size]
    for _t in range(t0):
        nm, ns = [], []
        for s in range(0, mlo.shape[0], chunk):
            m = mlo[s : s + chunk]
            N = m.shape[0]
            st = torch.stack([m, torch.zeros_like(m), size[s : s + chunk],
                              torch.zeros_like(m)])
            out, _v, _far = candidate_step_plain(
                index, st, torch.ones(N, dtype=torch.uint8, device=dev), per_block=N,
                inner=N, nch=torch.zeros((1, 1), dtype=torch.uint8, device=dev),
                right=zeros.to(torch.uint8), act=ones, u=big, lreq=zeros, exact=True,
            )
            nm.append(out[0, :, :4])
            ns.append(out[2, :, :4])
        # prepending char c: code(c.w) = c*4^t + code(w) -> c-major order
        mlo = torch.cat(nm).T.reshape(-1).contiguous()
        size = torch.cat(ns).T.reshape(-1).contiguous()
        mlo_parts.append(mlo)
        size_parts.append(size)
    return torch.cat(mlo_parts), torch.cat(size_parts)


def seed_build_depth() -> int:
    """The deepest level that `seed_build`'s first launch fills."""
    return SEED_BUILD.fn("_depth")()


def seed_build(index, t0: int):
    """The seed tables of an index part: the FMD interval (seed_mlo,
    seed_size) of every ACGT string of length 0..t0, levels back to back
    (`rank.seed_level_offset`), entry c * 4^t + code(w) of level t + 1 the
    string c.w; [(4^(t0+1) - 1) / 3] int32 each, holding uint32.  Level 0
    is (0, n_total); empty intervals keep the mlo that the extension gives.

    On a CUDA index: one launch for levels 0..min(t0, seed_build_depth())
    and one per deeper level, with no host sync and no PyTorch op between
    them; the tables are allocated once and written in place."""
    if not index.fwd_blocks.is_cuda:
        return seed_build_plain(index, t0)
    dev = index.device
    if not 0 <= t0 <= SEED_T_MAX:
        raise ValueError(f"seed_build: t0={t0} outside 0..{SEED_T_MAX}")
    _check(index.fwd_blocks, "fwd_blocks", torch.int32, device=dev)
    _check(index.C, "C", torch.int32, device=dev)
    if index.C.numel() < 4:
        raise ValueError("seed_build: C needs its A, C, G, T entries")
    total = rank.seed_level_offset(t0 + 1)
    mlo = torch.empty(total, dtype=torch.int32, device=dev)
    size = torch.empty(total, dtype=torch.int32, device=dev)
    nrows, row_w = index.fwd_blocks.shape
    rows = (index.fwd_blocks.data_ptr(), row_w, nrows, int(index.has_n), index.C.data_ptr())
    out, stream = (mlo.data_ptr(), size.data_ptr()), _stream(mlo)
    L = min(t0, seed_build_depth())
    SEED_BUILD.launch(*rows, int(index.n_total) & rank.MASK32, L, *out, stream,
                      entry="_shallow")
    for t in range(L, t0):
        SEED_BUILD.launch(*rows, t, *out, stream, entry="_level")
    return mlo, size


# ---------------------------------------------------------------------------
# 12. extend_level
# ---------------------------------------------------------------------------

EXTEND_LEVEL = Kernel(
    # _ext_phase (:907) and _ext_phase_fused (:1020), with the levels of
    # _extend_to_kmers (:1124): consecutive tree levels, each its pmap
    # gather, cut or pad, and its steps with their compactions
    "extend_level", "extend_level.cu", "genmap_tpu/search/engine.py:907/1020/1124",
    [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _L, _L, _L, _I, _P, _P, _P, _P,
     _P, _P, _L, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P],
)
EXTEND_LEVEL_MAX_LEVELS = 16  # levels a launch runs at most (csrc/extend_level.cu)
# dynamic shared memory a block of the kernel takes at most (EL_SMEM_MAX):
# one warp's two frontiers of the widest level's Fe states
EXTEND_LEVEL_SMEM = 196608


def extend_level_plain(index, st, valid, needles, pmaps, tabs, widths, *, dimer: bool,
                       exact: bool, errors: int, cap=None, far=None,
                       with_occ: bool = False):
    """Plain PyTorch version of `extend_level`: per level the pmap gather,
    the cut (`compact_plain` to its width), and per step
    `candidate_step_plain` or `dimer_step_plain` on every state and
    `compact_plain` of every (block, node) row."""
    R, B = st.shape[:2]
    dev = st.device
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    ovf_far = torch.zeros_like(ovf)
    occs = []
    for pmap, tab, Fe in zip(pmaps, tabs, widths):
        Mp, Fp = st.shape[2:]
        M, T = pmap.shape[0], tab.shape[1]
        p = pmap.to(torch.int64)
        x, v, of = compact_plain(st[:, :, p].reshape(R, B * M, Fp),
                                 valid[:, p].reshape(B * M, Fp), Fe)
        ovf |= of.view(B, M).bool().any(dim=-1)
        occ = (torch.zeros(B, dtype=torch.int32, device=dev) if T else
               v.view(B, M, Fe).sum(dim=-1, dtype=torch.int32).amax(dim=-1))
        u = torch.full((M,), errors, dtype=torch.int32, device=dev)
        zero = torch.zeros(M, dtype=torch.int32, device=dev)
        pos = tab[2:].to(torch.int64)
        for t in range(T):
            cons, right = tab[0, t].to(torch.uint8), tab[1, t].to(torch.uint8)
            step = dict(per_block=M * Fe, inner=Fe, right=right, exact=exact)
            if dimer:
                kinds = set(cons.tolist())
                out, valid2, f = dimer_step_plain(
                    index, x.reshape(R, -1), v.reshape(-1), consume=cons, u_mid=u,
                    u_end=u, l_mid=zero, l_end=zero, nchA=needles[:, pos[0, t]],
                    nchB=needles[:, pos[1, t]], with_mono=1 in kinds,
                    with_pass=0 in kinds, **step)
            else:
                out, valid2, f = candidate_step_plain(
                    index, x.reshape(R, -1), v.reshape(-1), nch=needles[:, pos[0, t]],
                    act=cons, u=u, lreq=zero, **step)
            x, v, of, n = compact_plain(out.reshape(R, B * M, -1),
                                        valid2.reshape(B * M, -1), Fe, True)
            ovf |= of.view(B, M).bool().any(dim=-1)
            ovf_far |= f.view(B, -1).bool().any(dim=-1)
            occ = torch.maximum(occ, n.view(B, M).amax(dim=-1))
        st, valid = x.view(R, B, M, Fe), v.view(B, M, Fe)
        occs.append(occ)
    if cap is not None:
        ovf |= cap.bool()
    if far is not None:
        ovf_far |= far.bool()
    res = (st, valid, ovf, ovf_far)
    return res + (torch.stack(occs, dim=1),) if with_occ else res


def extend_level(index, st, valid, needles, pmaps, tabs, widths, *, dimer: bool,
                 exact: bool, errors: int, cap=None, far=None, with_occ: bool = False):
    """Consecutive levels of the doubling-tree extension (`search/engine.py`
    `_tree_levels`) of every block of a batch, in one launch.

    st [4, B, Mp, Fp] int32 (flo, rlo, size, err) and valid [B, Mp, Fp]
    uint8: the first level's parent frontiers; per level (the sequences
    `pmaps`, `tabs`, `widths`, at most EXTEND_LEVEL_MAX_LEVELS): pmap [M]
    int32, each of its M nodes' parent in the level before; tab [4, T, M]
    int32, per step and node consume (0 passthrough, 1 one character, 2
    two: the dimer rows only), right, and the needle positions of its first
    and second character; its width Fe.  needles [B, Ln] uint8; errors:
    every node's error bound.  Each (block, node) frontier is its parent's
    first Fe valid states, in order, then each step extends every state by
    every candidate (as `candidate_step`, or `dimer_step` with `dimer`;
    `exact` picks the rank mode) and keeps the first Fe valid candidates in
    (state, slot) order (as `compact`).  cap / far [B] (bool or uint8,
    None: none) are the block flags so far.

    Returns (st [4, B, M, Fe] int32, valid [B, M, Fe] uint8: the last
    level's frontiers, zeros past their count; cap [B] bool: cap or more
    valid states than a cut or a step kept; far [B] bool: far or a step's
    far), and with `with_occ` occ [B, levels] int32: per block and level
    the most candidates a step had before its cut (on a stepless level the
    most states a cut kept).  Every output is written."""
    if not st.is_cuda:
        return extend_level_plain(index, st, valid, needles, pmaps, tabs, widths,
                                  dimer=dimer, exact=exact, errors=errors, cap=cap,
                                  far=far, with_occ=with_occ)
    dev = st.device
    R, B, Mp, Fp = st.shape
    n = len(widths)
    widths = [int(w) for w in widths]
    Ms = [int(p.shape[0]) for p in pmaps]
    Ts = [int(t.shape[1]) if t.dim() == 3 else -1 for t in tabs]
    if (R != 4 or not 1 <= n <= EXTEND_LEVEL_MAX_LEVELS or len(pmaps) != n
            or len(tabs) != n or min(Ts) < 0 or min(Ms) < 1 or min(widths) < 1
            or 32 * max(widths) > EXTEND_LEVEL_SMEM or Mp < 1 or Fp < 1):
        raise ValueError(f"extend_level: bad geometry R={R} Mp={Mp} Fp={Fp} M={Ms} "
                         f"T={Ts} widths={widths}")
    if dimer and not index.has_dimer:
        raise ValueError("extend_level: the index part has no dimer rows")
    _check(st, "st", torch.int32, device=dev)
    _check(valid, "valid", torch.uint8, (B, Mp, Fp), dev)
    _check(needles, "needles", torch.uint8, (B, needles.shape[-1]), dev)
    for pmap, tab, M, T in zip(pmaps, tabs, Ms, Ts):
        _check(pmap, "pmap", torch.int32, (M,), dev)
        _check(tab, "tab", torch.int32, (4, T, M), dev)
    for name, t in (("cap", cap), ("far", far)):
        if t is not None:
            _check(t, name, t.dtype, (B,), dev)
            if t.dtype not in (torch.bool, torch.uint8):
                raise TypeError(f"{name}: expected bool or uint8, got {t.dtype}")
    rows = index.dimer_blocks if dimer else index.fwd_blocks
    _check(rows, "rank rows", torch.int32, device=dev)
    M, Fe = Ms[-1], widths[-1]
    out = torch.empty((4, B, M, Fe), dtype=torch.int32, device=dev)
    out_valid = torch.empty((B, M, Fe), dtype=torch.uint8, device=dev)
    cap_out = torch.empty((B,), dtype=torch.bool, device=dev)
    far_out = torch.empty((B,), dtype=torch.bool, device=dev)
    occ = torch.empty((B, n), dtype=torch.int32, device=dev) if with_occ else None
    res = (out, out_valid, cap_out, far_out) + ((occ,) if with_occ else ())
    if B == 0:
        return res
    # the levels between the first and the last pass their packed frontiers
    # [4, B, Msc, Fsc] and counts [B, Msc] through one or two scratch buffers
    Msc, Fsc = (max(Ms[:-1]), max(widths[:-1])) if n > 1 else (0, 0)
    scratch = (torch.empty(min(2, n - 1) * B * Msc * (4 * Fsc + 1), dtype=torch.int32,
                           device=dev) if n > 1 else None)
    EXTEND_LEVEL.launch(
        rows.data_ptr(), rows.shape[1], sub_width(index.has_n), index.C.data_ptr(),
        (index.C2 if dimer else index.C).data_ptr(), int(index.has_n), index.nchars,
        int(dimer), int(exact), int(errors), st.data_ptr(), valid.data_ptr(), B, Mp, Fp,
        n, (_P * n)(*(p.data_ptr() for p in pmaps)), (_P * n)(*(t.data_ptr() for t in tabs)),
        (_I * n)(*Ts), (_I * n)(*Ms), (_I * n)(*widths), needles.data_ptr(),
        needles.shape[1], None if cap is None else cap.data_ptr(),
        None if far is None else far.data_ptr(),
        None if scratch is None else scratch.data_ptr(), Msc, Fsc, out.data_ptr(),
        out_valid.data_ptr(), cap_out.data_ptr(), far_out.data_ptr(),
        None if occ is None else occ.data_ptr(), _stream(st),
    )
    return res


KERNELS = {k.name: k for k in (EXTRACT_NEEDLES, CANDIDATE_STEP, COMPACT,
                               COUNT_TAIL, PROBE_MASS, LOCATE, DIMER_STEP,
                               SEED_LOOKUP, GATHER_STATES, ROW_GATHER, SEED_BUILD,
                               EXTEND_LEVEL)}
