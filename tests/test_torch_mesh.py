"""Multi-rank maps of genmap_tpu_torch against genmap_tpu's mesh engines.

The port's ranks are processes spawned by `parallel.dist.launch_local` over
gloo (torch.set_num_threads(1) in each); they import this module, which
imports only numpy, torch and genmap_tpu_torch at its top, and write their
results to tmp_path.  The test process builds the JAX engine of the same
shape on conftest's virtual CPU devices (data_mesh(2): 2 devices,
part_data_mesh(2, 4): 4) and compares: frequencies, -d / -ep locations,
stats (probe_skipped, blocks per tier, max_tier, escalated blocks) and
the calibrated pools, exactly.  The inputs are tests/test_multichip.py's
cases.  Every rank must hold the same results.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from genmap_tpu_torch.parallel.dist import launch_local

torch.set_num_threads(1)

RANK_TIMEOUT = 420  # launch_local ends a world that runs longer


# ---------------------------------------------------------------------------
# inputs (tests/test_multichip.py), built by either package's build_index
# ---------------------------------------------------------------------------


def _case(name):
    """(ids, seqs, build_index kwargs, (K, e, o), engine kwargs, engine
    attributes, csv, exclude_pseudo)."""
    if name == "mk_data":  # _mk_data(): 2 x 2000 bp, one part
        rng = np.random.default_rng(0)
        seqs = [rng.integers(0, 4, size=2000, dtype=np.uint8) for _ in range(2)]
        return (["c1", "c2"], seqs, dict(sampling=5), (12, 2, 9),
                dict(batch_blocks=32), {}, False, False)
    if name == "two_part":  # test_part_sharded_matches_single
        rng = np.random.default_rng(3)
        seqs = [rng.integers(0, 4, size=800, dtype=np.uint8) for _ in range(4)]
        return (["c1", "c2", "c3", "c4"], seqs,
                dict(sampling=5, max_part_symbols=3300), (12, 2, 9),
                dict(batch_blocks=32), {}, False, False)
    if name == "probe_dimer":  # test_part_sharded_probe_and_dimer
        rng = np.random.default_rng(11)
        n = 140_000
        s = rng.integers(0, 4, size=n, dtype=np.uint8)
        s[n // 2 : n // 2 + 3000] = np.tile(s[1000:1300], 10)
        return (["c1", "c2"], [s[: n // 2], s[n // 2 :]],
                dict(sampling=5, max_part_symbols=160_000), (64, 1, 33),
                dict(batch_blocks=512, dedup=False, dimer_tier=True), {}, False, False)
    if name == "calibration":  # test_part_sharded_calibration
        rng = np.random.default_rng(13)
        core = rng.integers(0, 4, size=6000, dtype=np.uint8)
        pieces = []
        for _ in range(20):
            seg = core[rng.integers(0, 5000) :][: rng.integers(200, 800)].copy()
            idx = rng.integers(0, len(seg), max(1, len(seg) // 60))
            seg[idx] = rng.integers(0, 4, len(idx))
            pieces.append(seg)
            pieces.append(rng.integers(0, 4, size=400, dtype=np.uint8))
        s = np.concatenate(pieces).astype(np.uint8)
        return (["c1", "c2"], [s[: len(s) // 2], s[len(s) // 2 :]],
                dict(sampling=5, max_part_symbols=len(s) + 10_000), (18, 1, 15),
                dict(batch_blocks=256, dedup=False), {"_cal_batch": 96}, False, False)
    assert name == "csv"  # test_part_sharded_csv_native: -d and -ep
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, size=500, dtype=np.uint8)
    seqs = [base.copy(),
            np.concatenate([base[:250], rng.integers(0, 4, 250, dtype=np.uint8)])]
    return (["c1", "c2"], seqs, dict(sampling=5, max_part_symbols=2000), (10, 1, 8),
            dict(batch_blocks=16), {}, True, True)


def _build(pkg, name):
    import importlib

    build_index = importlib.import_module(f"{pkg}.index.build").build_index
    FastaFile = importlib.import_module(f"{pkg}.io.fasta").FastaFile
    ids, seqs, kw, *_ = _case(name)
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = list(ids), [s.copy() for s in seqs]
    return build_index([ff], **kw)


def _result(eng, res):
    st = eng.stats
    return dict(
        c=res.c, locations=res.locations,
        stats={k: st[k] for k in ("probe_skipped", "max_tier", "overflow_blocks")},
        tier_blocks=dict(st["tier_blocks"]),
        tuned=dict(eng._tuned_pools),
    )


def _mesh(kind: str):
    from genmap_tpu_torch.parallel.mesh import data_mesh
    from genmap_tpu_torch.parallel.partmesh import part_data_mesh

    return data_mesh(2) if kind == "data2" else part_data_mesh(2, 4)


def port_rank(name: str, kind: str, out_dir: str) -> None:
    """One rank of the port's map of case `name` on mesh `kind`."""
    import torch.distributed as dist

    from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams

    _ids, _seqs, _kw, (K, e, o), eng_kw, attrs, csv, ep = _case(name)
    data = _build("genmap_tpu_torch", name)
    eng = MappabilityEngine(data, mesh=_mesh(kind), device="cpu", **eng_kw)
    for k, v in attrs.items():
        setattr(eng, k, v)
    res = eng.compute_file(eng.layouts[0], SearchParams(K, o, True, ep), e, 65535,
                           csv=csv)
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(_result(eng, res), f)


def _jax_result(name, kind):
    import jax

    from genmap_tpu.engine.mappability import MappabilityEngine, SearchParams
    from genmap_tpu.parallel.mesh import data_mesh
    from genmap_tpu.parallel.partmesh import part_data_mesh

    assert len(jax.devices()) >= 4, "conftest must provide the virtual devices"
    _ids, _seqs, _kw, (K, e, o), eng_kw, attrs, csv, ep = _case(name)
    data = _build("genmap_tpu", name)
    mesh = data_mesh(2) if kind == "data2" else part_data_mesh(2, 4)
    eng = MappabilityEngine(data, mesh=mesh, **eng_kw)
    assert eng.part_sharded == (kind == "part2x2")
    for k, v in attrs.items():
        setattr(eng, k, v)
    res = eng.compute_file(eng.layouts[0], SearchParams(K, o, True, ep), e, 65535,
                           csv=csv)
    return _result(eng, res)


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got["c"], want["c"], err_msg=what)
    assert got["stats"] == want["stats"], what
    assert got["tier_blocks"] == want["tier_blocks"], what
    assert got["tuned"] == want["tuned"], what
    assert set(got["locations"]) == set(want["locations"]), what
    for k, (gf, gr) in got["locations"].items():
        for a, b in zip((*gf, *gr), (*want["locations"][k][0], *want["locations"][k][1])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _run_world(tmp_path, fn, *args, world):
    out = tmp_path / "ranks"
    out.mkdir()
    launch_local(world, fn, *args, str(out), device="cpu", store_dir=str(tmp_path),
                 timeout_s=RANK_TIMEOUT)
    res = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name,kind", [
    ("mk_data", "data2"),
    ("two_part", "data2"), ("two_part", "part2x2"),
    ("probe_dimer", "data2"), ("probe_dimer", "part2x2"),
    ("calibration", "data2"), ("calibration", "part2x2"),
    ("csv", "data2"), ("csv", "part2x2"),
])
def test_mesh_engine_matches_jax_mesh(tmp_path, name, kind):
    want = _jax_result(name, kind)
    ranks = _run_world(tmp_path, port_rank, name, kind,
                       world=2 if kind == "data2" else 4)
    if name == "probe_dimer":
        assert want["stats"]["probe_skipped"] > 0
    if name == "calibration":
        assert want["tuned"], "calibration did not run"
    if name == "csv":
        assert want["locations"]
    for r, got in enumerate(ranks):
        _assert_same(got, want, f"{name} on {kind}, rank {r}")


# ---------------------------------------------------------------------------
# the merges over the part line, at a gloo world of 2 (part(2) x data(1))
# ---------------------------------------------------------------------------


def merge_rank(out_dir: str) -> None:
    import torch.distributed as dist

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.parallel.partmesh import merge_parts, part_data_mesh

    mesh = part_data_mesh(2, 2)
    r = dist.get_rank()
    B, J, T = 3, 2, 4
    out = dict(
        hits=torch.tensor([[40_000, 1], [7, 65_535], [0, 0]], dtype=torch.int32)
        .to(torch.uint16),
        overflow=torch.tensor([r == 0, False, r == 1]),
        overflow_cap=torch.tensor([False, False, r == 1]),
        # 0xFFFFFFF0 + 0x20 wraps to 0x10 (uint32), 2^31 - 1 + 1 passes 2^31
        exact_size=torch.tensor([[-16, 2**31 - 1], [5, 0], [0, 0]], dtype=torch.int32)
        if r == 0 else torch.tensor([[32, 1], [6, 0], [0, 0]], dtype=torch.int32),
        exact_size_total=torch.full((B, J), r + 1, dtype=torch.int32),
        occ=torch.tensor([[1, 9, 3, 0]] * B, dtype=torch.int32).to(torch.uint16)
        if r == 0 else torch.tensor([[4, 2, 3, 60_000]] * B, dtype=torch.int32)
        .to(torch.uint16),
        surv=torch.tensor([r, 5 - r, 0], dtype=torch.int32).to(torch.uint16),
    )
    assert out["occ"].shape == (B, T)
    merged = merge_parts(mesh, out, cap=65_535)
    capped = merge_parts(mesh, {k: out[k] for k in ("hits", "overflow", "overflow_cap")},
                         cap=255)
    # probe: each part's accumulator (saturated masses, flags) summed, then
    # decided by the probe_mass entry on the reduced sum
    P = 2
    acc = torch.tensor([[2**32 - 1, 0, 0], [1, 0, 0], [0, 1, r], [0, 0, 0]],
                       dtype=torch.int64)
    thr = torch.tensor([1, 1], dtype=torch.int32)
    summed = mesh.all_reduce(acc.clone(), "part")
    skip, mass = kernels.probe_mass(None, None, None, None, thr, False, True, acc=summed)
    assert acc.shape[1] == P + 1
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(dict(merged={k: v.numpy() for k, v in merged.items()},
                         capped=capped["hits"].numpy(), skip=skip.numpy(),
                         mass=mass.numpy(), collectives=mesh.collectives), f)


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("merges"), merge_rank, world=2)


@pytest.mark.timeout(300)
def test_merge_hits_widen_and_clamp(merges):
    for m in merges:
        # 40,000 + 40,000 passes uint16: widened, summed, clamped at cap
        assert m["merged"]["hits"].dtype == np.uint16
        np.testing.assert_array_equal(m["merged"]["hits"], [[65_535, 2], [14, 65_535], [0, 0]])
        np.testing.assert_array_equal(m["capped"], [[255, 2], [14, 255], [0, 0]])


@pytest.mark.timeout(300)
def test_merge_exact_size_wraps_like_uint32_psum(merges):
    for m in merges:
        got = m["merged"]["exact_size"].view(np.uint32)
        want = (np.array([[0xFFFFFFF0, 2**31 - 1], [5, 0], [0, 0]], np.uint64)
                + np.array([[32, 1], [6, 0], [0, 0]], np.uint64)) % 2**32
        np.testing.assert_array_equal(got, want.astype(np.uint32))
        np.testing.assert_array_equal(m["merged"]["exact_size_total"], 3)


@pytest.mark.timeout(300)
def test_merge_overflow_ors(merges):
    for m in merges:
        np.testing.assert_array_equal(m["merged"]["overflow"], [True, False, True])
        np.testing.assert_array_equal(m["merged"]["overflow_cap"], [False, False, True])


@pytest.mark.timeout(300)
def test_merge_occupancy_takes_the_max(merges):
    for m in merges:
        np.testing.assert_array_equal(m["merged"]["occ"], [[4, 9, 3, 60_000]] * 3)
        np.testing.assert_array_equal(m["merged"]["surv"], [1, 5, 0])
        # one SUM and one MAX all_reduce over the part line; the probe's one
        assert m["collectives"] == 2 + 1 + 1


@pytest.mark.timeout(300)
def test_probe_accumulator_saturates_and_decides(merges):
    for m in merges:
        # 2 x (2^32 - 1) saturates at 2^32 - 1; 1 + 1 = 2 > thr; a flag
        # on either part blocks the skip
        np.testing.assert_array_equal(m["mass"].view(np.uint32),
                                      [[2**32 - 1, 0], [2, 0], [0, 2], [0, 0]])
        np.testing.assert_array_equal(m["skip"], [0, 0, 0, 1])


# ---------------------------------------------------------------------------
# padding ranks, the CLI on a mesh, the dryrun, the environment
# ---------------------------------------------------------------------------


def lone_block_rank(kind: str, out_dir: str) -> None:
    """A selection of one block: every batch is padding on data rank 1."""
    import torch.distributed as dist

    from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams

    data = _build("genmap_tpu_torch", "two_part")
    eng = MappabilityEngine(data, batch_blocks=32, mesh=_mesh(kind), device="cpu")
    res = eng.compute_file(eng.layouts[0], SearchParams(12, 9, True), 2, 65535,
                           intervals=[(100, 103)])
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(dict(c=res.c, batches=eng.stats["batches"]), f)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["data2", "part2x2"])
def test_rank_without_a_valid_block_finishes(tmp_path, kind):
    from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams

    ranks = _run_world(tmp_path, lone_block_rank, kind,
                       world=2 if kind == "data2" else 4)
    data = _build("genmap_tpu_torch", "two_part")
    eng = MappabilityEngine(data, batch_blocks=32, device="cpu")
    want = eng.compute_file(eng.layouts[0], SearchParams(12, 9, True), 2, 65535,
                            intervals=[(100, 103)]).c
    assert (want[100:103] >= 1).all() and not want[:100].any()
    for got in ranks:
        np.testing.assert_array_equal(got["c"], want)
        assert got["batches"] >= 1


def cli_rank(idx: str, out_dir: str) -> None:
    import torch.distributed as dist

    from genmap_tpu_torch.cli.map_cmd import map_main
    from genmap_tpu_torch.parallel.mesh import data_mesh

    out = os.path.join(out_dir, "mesh")
    os.makedirs(out, exist_ok=True)
    dist.barrier()
    assert map_main(["-I", idx, "-O", out + "/", "-K", "12", "-E", "2", "-fl", "-r",
                     "-t", "--device", "cpu"], mesh=data_mesh(2)) == 0
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump({}, f)


@pytest.mark.timeout(300)
def test_cli_map_on_a_mesh_writes_once_and_equals_one_device(tmp_path):
    from genmap_tpu_torch.cli.main import main

    ids, seqs, *_ = _case("two_part")
    fa = tmp_path / "g.fa"
    fa.write_text("".join(f">{i}\n{''.join('ACGT'[x] for x in s)}\n"
                          for i, s in zip(ids, seqs)))
    idx = str(tmp_path / "idx")
    assert main(["index", "-F", str(fa), "-I", idx]) == 0
    one = tmp_path / "one"
    one.mkdir()
    assert main(["map", "-I", idx, "-O", str(one) + "/", "-K", "12", "-E", "2", "-fl",
                 "-r", "-t", "--device", "cpu"]) == 0
    _run_world(tmp_path, cli_rank, idx, world=2)
    mesh_out = tmp_path / "ranks" / "mesh"
    assert sorted(os.listdir(mesh_out)) == sorted(os.listdir(one))
    for fn in os.listdir(one):
        assert (mesh_out / fn).read_bytes() == (one / fn).read_bytes(), fn


def dryrun_rank(out_dir: str) -> None:
    import torch.distributed as dist

    from genmap_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4, "cpu")
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.mark.timeout(600)
def test_dryrun_multichip_4_matches_jax(tmp_path, capsys):
    import __graft_entry__ as ge

    ge.dryrun_multichip(4)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("dryrun_multichip(4)")]
    ranks = _run_world(tmp_path, dryrun_rank, world=4)
    assert len(want) == 2
    for got in ranks:
        assert got["lines"] == want
        assert got["mode"] == "part(2) x data(2)"


@pytest.mark.timeout(60)
def test_maybe_initialize_without_environment_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from genmap_tpu_torch.parallel.dist import is_writer, maybe_initialize

    for var in ("GENMAP_DIST_COORDINATOR", "GENMAP_DIST_NPROCS", "GENMAP_DIST_PROC_ID",
                "GENMAP_DIST_AUTO"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize("cpu") is False
    assert not dist.is_initialized()
    assert is_writer()
