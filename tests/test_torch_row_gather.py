"""The port's row gather (P1) against the Pallas harness's own code.

`benchmarks/pallas_experiments.py` is read and never edited: its nested
`xla_chain`, `dma_kernel` and `pallas_dma_sum` are cut out of `main` with
`ast`, dedented and exec'd over a small table, with `pl.pallas_call` in
Pallas's TPU interpret mode (`pltpu.InterpretParams`) so that the harness's
per-row DMA kernel itself runs on the CPU.  The same numpy inputs go
through `kernels.row_gather_sum` / `row_gather_chain` (on CPU tensors:
their plain versions).  All arithmetic is integer; every comparison is
exact.  The CUDA kernel is held against the plain versions in
tests/test_torch_kernels_cuda.py.
"""

import ast
import functools
import os
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from genmap_tpu_torch import kernels
from genmap_tpu_torch.experiments import row_gather as rg

torch.set_num_threads(1)

HARNESS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "benchmarks", "pallas_experiments.py")
NR, W, STEPS, CHUNK = 997, 128, 8, 128


def _harness(table, ND):
    """The harness's `xla_chain` and `pallas_dma_sum`, closed over `table`."""
    with open(HARNESS) as f:
        src = f.read()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    nested = {n.name: n for n in main.body if isinstance(n, ast.FunctionDef)}
    pl_interpret = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()),
        ds=pl.ds, BlockSpec=pl.BlockSpec, ANY=pl.ANY)
    ns = dict(jax=jax, jnp=jnp, pl=pl_interpret, pltpu=pltpu, table=jnp.asarray(table),
              NR=table.shape[0], W=table.shape[1], STEPS=STEPS, CHUNK=CHUNK, ND=ND)
    for name in ("xla_chain", "dma_kernel", "pallas_dma_sum"):
        seg = ast.get_source_segment(src, nested[name], padded=True)
        exec(textwrap.dedent(seg), ns)
    return ns["xla_chain"], ns["pallas_dma_sum"]


def _table(kind):
    if kind == "harness":
        return rg.harness_inputs(NR, W, 4096, 1024)[0]
    return rg.negative_wrap_table(NR, W, seed=7)


def _wrapped_sum(a) -> int:
    """The int32 that an int32 sum of `a` wraps to."""
    return int(np.int64(a.astype(np.int64).sum()).astype(np.int32))


def _chain_numpy(table, idx, steps, wrap=True, floor=True):
    """xla_chain in numpy; wrap=False skips the int32 wrap of the row sums
    before the modulo, floor=False takes C's truncating modulo."""
    c = idx.astype(np.int64)
    for _ in range(steps):
        s = table[c].astype(np.int64).sum(axis=1)
        if wrap:
            s = s.astype(np.int32).astype(np.int64)
        c = np.mod(s, NR) if floor else np.fmod(s, NR)
    return _wrapped_sum(c)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind,ND", [("harness", 640), ("harness", 700),
                                     ("negative-wrap", 1000)])
def test_sum_equals_the_harness_pallas_dma_sum(kind, ND):
    table = _table(kind)
    idx = np.random.default_rng(ND).integers(0, NR, size=ND).astype(np.int32)
    _chain, pallas_dma_sum = _harness(table, ND)
    want = int(pallas_dma_sum(jnp.asarray(idx)))
    n_used = ND // CHUNK * CHUNK  # the fori_loop covers whole chunks only
    assert want == _wrapped_sum(table[idx[:n_used]])
    tt, ti = torch.from_numpy(table), torch.from_numpy(idx)
    assert int(kernels.row_gather_sum_plain(tt, ti, chunk=CHUNK)) == want
    for lanes in kernels.ROW_GATHER_LANES:
        got = kernels.row_gather_sum(tt, ti, chunk=CHUNK, lanes=lanes)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == want


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["harness", "negative-wrap"])
def test_chain_equals_the_harness_xla_chain(kind):
    table = _table(kind)
    idx = np.random.default_rng(3).integers(0, NR, size=4096).astype(np.int32)
    xla_chain, _dma = _harness(table, CHUNK)
    want = int(jax.jit(xla_chain)(jnp.asarray(idx)))
    assert want == _chain_numpy(table, idx, STEPS)
    tt, ti = torch.from_numpy(table), torch.from_numpy(idx)
    assert int(kernels.row_gather_chain_plain(tt, ti, steps=STEPS)) == want
    for lanes in kernels.ROW_GATHER_LANES:
        assert int(kernels.row_gather_chain(tt, ti, steps=STEPS, lanes=lanes)) == want


@pytest.mark.parametrize("kind", ["harness", "negative-wrap"])
def test_chain_inputs_tell_both_traps_apart(kind):
    """The row sums wrap negative on these inputs, so a chain that takes the
    modulo of the unwrapped sum (trap 1) or truncates toward zero (trap 2)
    ends elsewhere than the harness's chain."""
    table = _table(kind)
    idx = np.random.default_rng(3).integers(0, NR, size=4096).astype(np.int32)
    sums = table.astype(np.int64).sum(axis=1).astype(np.int32)
    assert (sums < 0).mean() > (0.3 if kind == "harness" else 0.99)
    want = int(kernels.row_gather_chain_plain(torch.from_numpy(table),
                                              torch.from_numpy(idx), steps=STEPS))
    assert want == _chain_numpy(table, idx, STEPS)
    assert _chain_numpy(table, idx, STEPS, wrap=False) != want
    assert _chain_numpy(table, idx, STEPS, floor=False) != want


def test_harness_inputs_are_the_harness_draws():
    """harness_inputs draws table, chain ids and DMA ids in `main`'s order."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 2**30, size=(50, 8), dtype=np.int64).astype(np.int32)
    idx0 = rng.integers(0, 50, size=40).astype(np.int32)
    idx_d = rng.integers(0, 50, size=30).astype(np.int32)
    for a, b in zip(rg.harness_inputs(50, 8, 40, 30), (table, idx0, idx_d)):
        assert a.dtype == np.int32 and np.array_equal(a, b)


def test_wrappers_check_their_arguments():
    table = torch.from_numpy(_table("harness"))
    idx = torch.arange(100, dtype=torch.int32)
    assert int(kernels.row_gather_sum(table, idx, chunk=128)) == 0  # no whole chunk
    assert int(kernels.row_gather_chain(table, idx, steps=0)) == int(idx.sum())
    with pytest.raises(ValueError, match="lanes"):
        kernels.row_gather_sum(table, idx, lanes=16)
    with pytest.raises(ValueError, match="chunk"):
        kernels.row_gather_sum(table, idx, chunk=0)
    with pytest.raises(TypeError):
        kernels.row_gather_chain(table, idx.to(torch.int64))
    with pytest.raises(ValueError, match="blocks"):
        kernels.row_gather_chain(table, idx, blocks=-1)


@pytest.mark.timeout(300)
def test_entry_point_runs_on_the_cpu(capsys):
    kernels.reset_launches()
    assert rg.main(["--device", "cpu", "--quick"]) == 0
    out = capsys.readouterr().out
    for name in ("row_gather_chain (8-step chain)", "row_gather_sum (1 pass)"):
        assert any(line.startswith(name) and "Mrows/s" in line and "checksum" in line
                   for line in out.splitlines()), out[:2000]
    sweep = [line for line in out.splitlines() if line.startswith("sweep:")]
    assert all("host ms on the cpu" in line for line in sweep)
    for rb in rg.SWEEP_ROW_BYTES:
        assert any(f" {rb:4d} B rows" in line for line in sweep)
    assert any("blocks 8/SM" in line for line in sweep)
    assert kernels.launch_counts()["row_gather"] == 0  # CPU: the plain versions


def _view(row_bytes, table_bytes, misaligned=False):
    """A [NR, W] int32 table of table_bytes that allocates one row (a
    stride-0 view), 4 B off 16-byte alignment when asked."""
    W = row_bytes // 4
    base = torch.zeros(W + 4, dtype=torch.int32)[1 if misaligned else 0:][:W]
    return base.as_strided((table_bytes // row_bytes, W), (0, 1))


@pytest.mark.parametrize("row_bytes,table_bytes,n,misaligned,want,word", [
    (512, 16_000_000, 4096, False, 32, 8),       # the harness's sum
    (208, 20_000_000, 1 << 20, False, 8, 8),     # L2
    (416, 20_000_000, 1 << 20, False, 4, 4),
    (208, 4 << 30, 1 << 20, False, 0, 8),        # HBM: the bulk copies
    (276, 4 << 30, 1 << 20, False, 0, 8),        # Dna5 rows: the word kernel
    (512, 4 << 30, 1 << 20, False, 0, 8),
    (208, 4 << 30, 1 << 20, True, 0, 8),         # a table off alignment
    (512, 16_000_000, 1 << 17, False, 8, 8),     # the harness's chain
    (416, 256 << 20, 1 << 17, False, 0, 32),     # the sweep's 256 MiB table
    (416, (32 << 20) + 416, 1 << 17, True, 0, 32),  # just above the L2 threshold
    (640, 32 << 20, 1 << 17, False, 8, 8),       # at it; nearest width 512
    (1024, 4 << 30, 1 << 17, False, 0, 8),
])
def test_default_lanes_follow_the_measured_rule(row_bytes, table_bytes, n, misaligned,
                                                want, word):
    """`lanes=None` takes the measured rule, the same for the sum and the
    chain: 32 lanes below ROW_GATHER_SMALL ids; above ROW_GATHER_L2_BYTES
    the bulk copies (lanes 0), and where those do not apply (no table on
    the CPU, where no kernel runs) the word kernel of the nearest measured
    row width for that residency."""
    table = _view(row_bytes, table_bytes, misaligned)
    assert (table.data_ptr() % 16 != 0) == misaligned
    assert kernels.row_gather_lanes(table, n) == want
    assert kernels.row_gather_word_lanes(table) == word
    assert not kernels.row_gather_bulk(table, "sum")
    assert not kernels.row_gather_bulk(table, "chain")
