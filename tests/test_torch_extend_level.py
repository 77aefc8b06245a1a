"""The doubling-tree extension's fused levels (`kernels.extend_level`) on
the CPU: which frontiers take the kernel, the engine's fused path through
the kernel's plain version against the host loop of step and compact
calls (final states, flags and per-level demand equal), and the counters
that say which way each level ran.  Integer results: exact.

The kernel itself is held against the loop on the card by
tests/test_torch_kernels_cuda.py (marker `cuda`)."""

import numpy as np
import pytest
import torch

from genmap_tpu_torch import kernels, tracing
from genmap_tpu_torch.cli.main import main as torch_main
from genmap_tpu_torch.cli.map_cmd import map_main
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank
from genmap_tpu_torch.search import engine as te

torch.set_num_threads(1)


@pytest.mark.parametrize("Fe,slots,fused", [
    (1, 4, True), (4, 4, True), (128, 4, True), (512, 4, True), (1024, 4, True),
    (4096, 4, True), (8192, 4, False), (32768, 4, False),
    (4, 5, True), (256, 5, True), (2048, 5, True), (4096, 5, False),
    (1, 16, True), (16, 16, True), (128, 16, True), (1024, 16, True), (2048, 16, False),
])
def test_level_fuses_reads_width_and_slots(Fe, slots, fused):
    """Every rung of both row kinds up to 4,096 mono takes the kernel; a
    frontier whose candidates a step pass 16,384 keeps the loop."""
    assert te.level_fuses(Fe, slots) is fused
    assert te._fused_level(torch.zeros(1), Fe, slots) is False  # never on the CPU


_INPUTS = {}


def _genome(seed=4, n=5000):
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 240, dtype=np.uint8)
    copies = []
    for _ in range(12):
        u = unit.copy()
        m = rng.random(unit.size) < 0.02
        u[m] = rng.integers(0, 4, int(m.sum()))
        copies.append(u)
    return np.concatenate([rng.integers(0, 4, n, dtype=np.uint8), *copies,
                           rng.integers(0, 4, n // 2, dtype=np.uint8)])


def _inputs(K, E, dimer):
    """Phase-A survivors of B blocks at (K, E) on a genome with a 12-copy
    repeat (the batch's needles, index and levels beside them)."""
    key = (K, E, dimer)
    if key not in _INPUTS:
        ff = FastaFile(name="g.fa")
        ff.ids, ff.seqs = ["c1"], [_genome()]
        data = build_index([ff], sampling=5)
        index = rank.DeviceIndex.from_part(data, data.parts[0], light=True, device="cpu")
        text = rank.DeviceText.from_host(data, "cpu")
        J = 5 if K == 20 else 50
        O = K - J + 1
        B = 24
        rng = np.random.default_rng(K)
        starts = np.sort(rng.choice(np.arange(0, data.text_len - K - J, J), B,
                                    replace=False)).astype(np.uint32)
        starts[: B // 3] = 5000 + J * np.arange(B // 3)  # in the repeat
        run = te.BlockMapper(index, text, K=K, errors=E, overlap=O, J=J, B=B,
                             tier=te.Tier(32, 64, 8, exact=True, dimer=dimer), cap=65535,
                             rev_compl=True, collect_only=True)
        st_ = torch.from_numpy(starts.view(np.int32))
        out = run(st_, torch.full((B,), J, dtype=torch.int32), data.text_len)
        needles = rank.extract_needles(text, st_, K + J - 1, data.text_len)
        _INPUTS[key] = dict(index=index, B=B, J=J, K=K, E=E, needles=needles,
                            survivors=(out["st"], out["valid"]))
    return _INPUTS[key]


def _extend(b, Fe, exact, dimer, fe_sched, with_occ):
    levels = [te._ExtensionLevel(lv, b["E"], "cpu", dimer)
              for lv in te._tree_levels(b["J"], b["K"])]
    tier = te.Tier(4, max(4, Fe), Fe, exact=exact, dimer=dimer, ext_exact=exact)
    st, valid = kernels.gather_states_plain(*b["survivors"], torch.arange(b["B"],
                                            dtype=torch.int32), b["B"], Fe)
    sched = None if fe_sched is None else fe_sched(Fe, len(levels))
    return te._extend_to_kmers(b["index"], (st, valid), b["needles"], levels, b["B"],
                               tier, sched, with_occ)


def decaying(Fe, n):
    """A frontier schedule that shrinks down the tree (as `_ext_sched`
    adopts), a level behind the widest."""
    return [Fe] + [max(1, Fe >> (i // 2)) for i in range(n)]


def assert_same_extension(got, want):
    """Final states where valid, validity, both flags and (with occ) the
    per-level demand are equal."""
    (gst, gv), gcap, gfar, *gocc = got
    (wst, wv), wcap, wfar, *wocc = want
    assert torch.equal(gv, wv)
    m = wv.bool()[None]
    assert torch.equal(torch.where(m, gst, 0), torch.where(m, wst, 0))
    assert torch.equal(gcap, wcap) and torch.equal(gfar, wfar)
    assert len(gocc) == len(wocc)
    for a, b in zip(gocc, wocc):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,E", [(20, 1), (101, 2)], ids=["J5", "J50"])
@pytest.mark.parametrize("dimer,exact", [(False, False), (False, True), (True, False),
                                         (True, True)],
                         ids=["mono-fast", "mono-exact", "dimer-fast", "dimer-exact"])
@pytest.mark.parametrize("Fe,fe_sched,with_occ", [
    (1, None, False), (4, None, True), (16, decaying, True), (4, decaying, False)])
def test_fused_path_equals_the_loop(monkeypatch, K, E, dimer, exact, Fe, fe_sched,
                                    with_occ):
    """The engine's fused path (forced on the CPU, where it takes the
    kernel's plain version) gives the host loop's extension."""
    check_fused_path(monkeypatch, K, E, dimer, exact, Fe, fe_sched, with_occ)


@pytest.mark.parametrize("dimer,exact", [(False, True), (True, False)],
                         ids=["mono-exact", "dimer-fast"])
def test_wide_levels_loop_and_the_rest_fuse(monkeypatch, dimer, exact):
    """A schedule that starts past the budget (J = 5: widths 8,192, 8,192,
    4,096) loops its wide levels and fuses the rest, with the loop's
    results."""
    check_fused_path(monkeypatch, 20, 1, dimer, exact, 8192, decaying, True)


def check_fused_path(monkeypatch, K, E, dimer, exact, Fe, fe_sched, with_occ):
    b = _inputs(K, E, dimer)
    want = _extend(b, Fe, exact, dimer, fe_sched, with_occ)
    snap = tracing.snapshot()
    monkeypatch.setattr(te, "_fused_level", lambda st, Fe, slots: te.level_fuses(Fe, slots))
    got = _extend(b, Fe, exact, dimer, fe_sched, with_occ)
    n = len(te._tree_levels(b["J"], K))
    widths = fe_sched(Fe, n)[1:] if fe_sched else [Fe] * n
    fused = sum(te.level_fuses(w, 16 if dimer else 4) for w in widths)
    want_counts = {"mapper.ext_levels_fused": fused, "mapper.ext_levels_looped": n - fused}
    assert tracing.since(snap)["counters"] == {k: v for k, v in want_counts.items() if v}
    assert_same_extension(got, want)
    (st, valid), cap, far, *_ = want
    assert valid.any()
    if Fe == 1:
        assert cap.any()  # the cut and the steps overflow at width 1


@pytest.mark.parametrize("dimer", [False, True], ids=["mono", "dimer"])
def test_extend_level_runs_levels_and_leaves_its_inputs(dimer):
    """One call over a run of levels equals a call per level (flags and
    occupancy carried), its outputs are new tensors (flags included), and
    the frontier is zero past each row's count, as compact leaves it."""
    b = _inputs(101, 2, dimer)
    levels = [te._ExtensionLevel(lv, 2, "cpu", dimer) for lv in te._tree_levels(50, 101)]
    widths = [4, 4, 2, 2, 1, 1]
    st, valid = kernels.gather_states_plain(*b["survivors"],
                                            torch.arange(b["B"], dtype=torch.int32),
                                            b["B"], 4)
    st, valid = st.view(4, b["B"], 1, 4), valid.view(b["B"], 1, 4)
    cap = torch.zeros(b["B"], dtype=torch.bool)
    cap[0] = True
    far = torch.zeros(b["B"], dtype=torch.uint8)
    kw = dict(dimer=dimer, exact=True, errors=2, with_occ=True)
    out, ov, ocap, ofar, occ = kernels.extend_level(
        b["index"], st, valid, b["needles"], [lv.pmap32 for lv in levels],
        [lv.tab for lv in levels], widths, cap=cap, far=far, **kw)
    assert cap.sum() == 1 and far.sum() == 0  # inputs untouched
    assert ocap[0] and ocap.dtype == torch.bool and ofar.dtype == torch.bool
    assert out.shape == (4, b["B"], 50, 1) and occ.shape == (b["B"], len(levels))
    assert torch.equal(out * (1 - ov)[None], torch.zeros_like(out))
    x, v, c, f, occs = st, valid, cap, far, []
    for lv, w in zip(levels, widths):
        x, v, c, f, o = kernels.extend_level(b["index"], x, v, b["needles"], [lv.pmap32],
                                             [lv.tab], [w], cap=c, far=f, **kw)
        occs.append(o)
    for got, want in zip((out, ov, ocap, ofar, occ), (x, v, c, f, torch.cat(occs, dim=1))):
        assert torch.equal(got, want)
    assert ocap.sum() > 1 and (occ > 0).any()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("extlevels")
    codes = _genome(seed=6)
    with open(root / "g.fa", "w") as f:
        f.write(">c1\n" + np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode() + "\n")
    assert torch_main(["index", "-F", str(root / "g.fa"), "-I", str(root / "idx"),
                       "-S", "5"]) == 0
    return root


@pytest.mark.parametrize("K,E,fmt", [(30, 1, "-fs"), (20, 1, "-fl")],
                         ids=["split-J16", "fused-ladder-J5"])
def test_level_counters_on_a_cpu_map(monkeypatch, index_dir, K, E, fmt):
    """A CPU map runs every extension level as the loop, counts it once,
    and the counters reach the job's report."""
    ran = []
    extend = te._extend_to_kmers

    def counting(index, survivors, needles, levels, *a, **kw):
        ran.append(len(levels))
        return extend(index, survivors, needles, levels, *a, **kw)

    monkeypatch.setattr(te, "_extend_to_kmers", counting)
    out = index_dir / f"o{K}"
    out.mkdir()
    report = {}
    assert map_main(["-I", str(index_dir / "idx"), "-O", str(out) + "/", "-K", str(K),
                     "-E", str(E), fmt, "-r", "--device", "cpu"], report=report) == 0
    counters = report["trace"]["counters"]
    assert sum(ran) > 0
    assert counters.get("mapper.ext_levels_fused", 0) == 0
    assert counters["mapper.ext_levels_looped"] == sum(ran)
