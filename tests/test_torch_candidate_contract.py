"""`kernels.candidate_step`'s output contract is all that its consumers read.

The CUDA kernel leaves every slot of `out` undefined except the candidates
of valid active states and candidate 0 of valid passthrough states
(`kernels.candidate_step_defined`).  Here, on the CPU, a wrapper overwrites
every other slot of the plain version's `out` with a poison pattern; the
seed-table build, `map -d` on the fused path and the split pipeline must
then give the same results as without it (a second run, unwrapped) and as
the JAX package: so neither the engine, nor the seed build, nor compact
reads a slot that the contract leaves undefined.  Integer results: exact.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from genmap_tpu.alphabet import revcomp_codes
from genmap_tpu.cli.main import main as jax_main
from genmap_tpu.engine.oracle import _count, _windows
from genmap_tpu.index.build import build_index as jax_build_index
from genmap_tpu.io.fasta import FastaFile as JaxFastaFile
from genmap_tpu.ops import rank as jr
from genmap_tpu_torch import kernels
from genmap_tpu_torch.cli.main import main as torch_main
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank as tr

torch.set_num_threads(1)

POISON = 0x5A5A5A5A
_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


@contextlib.contextmanager
def poisoned(name="candidate_step"):
    """kernels.candidate_step (or `name`, another function of the step's
    signature) with every slot of `out` outside the contract overwritten by
    POISON; yields the calls seen as (R, passthrough)."""
    orig = getattr(kernels, name)
    seen = []

    def wrapper(index, st, valid, *, per_block, inner, act, **kw):
        out, valid2, far = orig(index, st, valid, per_block=per_block, inner=inner,
                                act=act, **kw)
        defined = kernels.candidate_step_defined(st, valid, act, per_block, inner,
                                                 out.shape[2])
        out = out.clone()
        out[:, ~defined] = POISON
        seen.append((st.shape[0], not bool(act.all())))
        return out, valid2, far

    setattr(kernels, name, wrapper)
    try:
        yield seen
    finally:
        setattr(kernels, name, orig)


def test_poison_covers_the_undefined_slots():
    """The wrapper poisons exactly the slots the contract leaves undefined:
    all candidates of invalid states and candidates 1.. of passthroughs."""
    st = torch.arange(4 * 6, dtype=torch.int32).view(4, 6)
    valid = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.uint8)
    act = torch.tensor([1, 0], dtype=torch.uint8)  # groups of 3 states
    d = kernels.candidate_step_defined(st, valid, act, per_block=6, inner=3, A=4)
    want = torch.tensor([[1, 1, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1],
                         [1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0]], dtype=torch.bool)
    assert torch.equal(d, want)


def _seed_data(alpha):
    rng = np.random.default_rng(31 + alpha)
    unit = rng.integers(0, 4, size=80, dtype=np.uint8)
    seqs = [np.concatenate([rng.integers(0, alpha, size=1500, dtype=np.uint8),
                            np.tile(unit, 8)]),
            rng.integers(0, alpha, size=700, dtype=np.uint8)]
    out = []
    for cls, build in ((FastaFile, build_index), (JaxFastaFile, jax_build_index)):
        ff = cls(name="g.fa")
        ff.ids, ff.seqs = ["s0", "s1"], seqs
        out.append(build([ff], sampling=3))
    return out


def _seed_tables(data, t0=None):
    part = data.parts[0]
    ti = tr.DeviceIndex.from_numpy(part.fwd.blocks, part.C, part.strand_blocks,
                                   has_n=data.has_n, sampling=data.sampling, device="cpu",
                                   seed_t0=t0)
    return tr.u32(ti.seed_mlo).numpy(), tr.u32(ti.seed_size).numpy()


@pytest.mark.parametrize("alpha", [4, 5])
def test_seed_build_reads_only_defined_slots(alpha):
    """The plain seed build (`kernels.seed_build_plain`, the reference the
    seed_build kernel is held against; the CPU's build) steps with
    `candidate_step_plain` and passes every state valid and active, so every
    slot it reads is defined: this checks that premise (every call seen is
    R = 4 with no passthrough group) and that the poisoned build equals the
    unwrapped one and JAX's.  No slot is poisoned here; the mutations of
    the next test show that a build reading undefined slots would fail."""
    data, jdata = _seed_data(alpha)
    with poisoned("candidate_step_plain") as seen:
        got = _seed_tables(data)
    assert seen and all(r == 4 and not p for r, p in seen)
    again = _seed_tables(data)
    ji = jr.DeviceIndex.from_part(jdata, jdata.parts[0])
    for g, a, j in zip(got, again, (ji.seed_mlo, ji.seed_size)):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("mutation", ["invalid", "inactive"])
def test_poison_reaches_a_seed_build_that_reads_undefined_slots(alpha, mutation):
    """A mutation planted in the seed build's calls, every 7th state
    invalid or the one group inactive (a passthrough: candidates 1.. are
    undefined), makes it read undefined slots: the poisoned build then
    differs from the unwrapped one under the same mutation.  One level
    deep, so that no poisoned interval is stepped again."""
    data, _jdata = _seed_data(alpha)

    @contextlib.contextmanager
    def mutated():
        orig = kernels.candidate_step_plain

        def wrapper(index, st, valid, *, act, **kw):
            if mutation == "invalid":
                valid = valid.clone()
                valid[::7] = 0
            else:
                act = torch.zeros_like(act)
            return orig(index, st, valid, act=act, **kw)

        kernels.candidate_step_plain = wrapper
        try:
            yield
        finally:
            kernels.candidate_step_plain = orig

    with poisoned("candidate_step_plain"), mutated():
        got = _seed_tables(data, t0=1)
    with mutated():
        want = _seed_tables(data, t0=1)
    assert any(not np.array_equal(g, w) for g, w in zip(got, want))
    assert any((g == POISON).any() for g in got)


def _write_fasta(path, seed=23):
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 90)
    chroms = {
        "chr1": np.concatenate([rng.integers(0, 4, 500), np.tile(unit, 4),
                                rng.integers(0, 4, 200)]),
        "chr2": np.concatenate([rng.integers(0, 4, 300), np.full(15, 4),
                                rng.integers(0, 5, 250)]),
    }
    with open(path, "w") as f:
        for name, codes in chroms.items():
            f.write(f">{name}\n{_ACGTN[codes].tobytes().decode()}\n")


def _tree(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as f:
            out[fn] = f.read()
    return out


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    root = tmp_path_factory.mktemp("contract")
    fa = str(root / "genome.fa")
    _write_fasta(fa)
    jidx, tidx = str(root / "jidx"), str(root / "tidx")
    assert jax_main(["index", "-F", fa, "-I", jidx, "-S", "4"]) == 0
    assert torch_main(["index", "-F", fa, "-I", tidx, "-S", "4"]) == 0
    return root, jidx, tidx


@pytest.mark.parametrize("K,E", [(24, 1), (20, 2)])
def test_fused_map_reads_only_defined_slots(indexes, K, E):
    """`map -d` (frequencies and CSV locations) on the fused path: poisoned,
    then unwrapped, then the JAX CLI, all byte-equal."""
    root, jidx, tidx = indexes
    argv = ["-K", str(K), "-E", str(E), "-d", "-fl", "-t"]
    outs = {}
    for name in ("poisoned", "plain", "jax"):
        d = root / f"{name}_{K}_{E}"
        d.mkdir()
        if name == "jax":
            assert jax_main(["map", "-I", jidx, "-O", str(d), *argv]) == 0
        else:
            with poisoned() if name == "poisoned" else contextlib.nullcontext([]) as seen:
                assert torch_main(["map", "-I", tidx, "-O", str(d), *argv,
                                   "--device", "cpu"]) == 0
            if name == "poisoned":  # infix (R = 5) and extension steps, passthroughs
                assert {(5, False), (4, True)} <= set(seen), set(seen)
        outs[name] = _tree(d)
    assert outs["poisoned"] and "genome.genmap.csv" in outs["poisoned"]
    assert outs["poisoned"] == outs["plain"] == outs["jax"]


def repeat_rich_genome(seed=11, n=48_000):
    """tests/test_torch_split.py's genome, shorter: half its segments are
    lightly mutated copies from a core a tenth of its length."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, size=n // 10, dtype=np.uint8)
    parts, tot = [], 0
    while tot < n:
        if rng.random() < 0.5:
            s = rng.integers(0, max(1, len(core) - 600))
            seg = core[s : s + rng.integers(100, 600)].copy()
            idx = rng.integers(0, len(seg), max(1, len(seg) // 80))
            seg[idx] = rng.integers(0, 4, len(idx))
        else:
            seg = rng.integers(0, 4, size=rng.integers(100, 600), dtype=np.uint8)
        parts.append(seg)
        tot += len(seg)
    return np.concatenate(parts)[:n].astype(np.uint8)


def test_split_pipeline_reads_only_defined_slots():
    """Calibration and the split pipeline (J = 16, tests/test_torch_split.py's
    engine settings): poisoned and unwrapped runs agree in frequencies and
    engine state, and the frequencies equal the JAX package's brute-force
    oracle on a sample (tests/test_torch_split.py holds the unwrapped
    engine equal to the JAX engine)."""
    seq = repeat_rich_genome()
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["c1"], [seq]
    data = build_index([ff], sampling=4)
    K, e, o = 30, 1, 15
    runs = []
    for wrap in (poisoned, lambda: contextlib.nullcontext([])):
        eng = MappabilityEngine(data, batch_blocks=1024, device="cpu")
        eng._cal_batch = 96
        eng._record_tier_sel = True
        with wrap() as seen:
            freq = eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 65535).c
        runs.append((freq, eng, seen))
    (got, eng, seen), (again, eng2, _) = runs
    assert eng.stats["rung_sel"] and eng._tuned_pools  # split and calibrated
    assert {r for r, _p in seen} == {4, 5}
    np.testing.assert_array_equal(got, again)
    assert eng.stats["tier_blocks"] == eng2.stats["tier_blocks"]
    assert eng._tuned_pools == eng2._tuned_pools
    assert eng._ext_sched == eng2._ext_sched
    assert eng.stats["routes"] == eng2.stats["routes"]
    for k, v in eng.stats["rung_sel"].items():
        np.testing.assert_array_equal(np.concatenate(v),
                                      np.concatenate(eng2.stats["rung_sel"][k]))
    rng = np.random.default_rng(K)
    nk = len(seq) - K + 1
    pos = np.concatenate([rng.integers(0, nk, 100),
                          rng.choice(np.nonzero(got[:nk] > 1)[0], 100)])
    q = np.lib.stride_tricks.sliding_window_view(seq, K)[pos]
    rc = np.stack([revcomp_codes(x) for x in q])
    targets = _windows([seq], K)
    oracle = _count(q, targets, e) + _count(rc, targets, e)
    np.testing.assert_array_equal(got[pos], np.minimum(oracle, 65535))
