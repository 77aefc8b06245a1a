"""The work that chip_smoke.py charges a kernel's bound with, held against
what the kernel's plain version does on the CPU.

`locate_work` counts the LF steps of the walks that `locate_plain` takes
(with the samples' positions set to 0, locate_plain's i2 is each row's
step count); `kernel_work("gather_states", ...)` counts the bytes that
`gather_states_plain` reads and writes.  Small indexes, ~10 s.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from genmap_tpu_torch import kernels
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_INDEX = {}


def _index(alpha, sampling):
    key = (alpha, sampling)
    if key not in _INDEX:
        rng = np.random.default_rng(10 * alpha + sampling)
        seq = rng.integers(0, 4, size=5000, dtype=np.uint8)
        seq[1000:1600] = np.tile(seq[:100], 6)
        if alpha == 5:
            seq[200:260] = 4
            seq[rng.integers(0, len(seq), 25)] = 4
        ff = FastaFile(name="g.fa")
        ff.seqs = [seq, rng.integers(0, 4, size=1500, dtype=np.uint8)]
        ff.ids = ["a", "b"]
        data = build_index([ff], sampling=sampling)
        _INDEX[key] = rank.DeviceIndex.from_part(data, data.parts[0], light=False,
                                                 device="cpu")
    return _INDEX[key]


def _rows(ix, clustered, seed):
    rng = np.random.default_rng(seed)
    n = ix.n_total
    if clustered:  # runs of consecutive SA rows, as -d draws them
        starts = rng.integers(0, n - 8, 300)
        pos = np.concatenate([np.arange(s, s + rng.integers(1, 8)) for s in starts])
    else:
        pos = rng.integers(0, n, 2000)
    valid = rng.random(len(pos)) < 0.9
    return (torch.from_numpy(pos.astype(np.uint32).view(np.int32)),
            torch.from_numpy(valid.astype(np.uint8)))


@pytest.mark.parametrize("clustered", [True, False])
@pytest.mark.parametrize("sampling", [1, 10, 32])
@pytest.mark.parametrize("alpha", [4, 5])
def test_locate_work_counts_the_plain_walks(alpha, sampling, clustered):
    cs = _smoke()
    ix = _index(alpha, sampling)
    pos, valid = _rows(ix, clustered, sampling + alpha)
    zero = dataclasses.replace(ix, sa_i2=torch.zeros_like(ix.sa_i2))
    _i1, per_row = kernels.locate_plain(zero, pos, valid)  # i2 = steps
    walk = cs.locate_walk(ix, pos, valid)
    assert torch.equal(walk["steps"], per_row.to(torch.int64))
    steps = int(per_row.sum())
    assert steps > 0 or sampling == 1  # sampling 1: (nearly) every row is sampled
    assert walk["sub"].numel() == walk["off"].numel() == walk["code"].numel() == steps
    nbytes, nops, shape, reads = cs.locate_work(dict(index=ix, pos=pos, valid=valid))
    assert f"{steps} LF steps" in shape
    # an indicator test per iteration of a live row: each step, and the
    # test that ends a walk before `sampling` steps
    ended = int(((per_row < sampling) & valid.bool()).sum())
    assert reads == 2 * steps + ended
    assert nops < steps * (32 * 10 + 2 * 16 * 4 + 10) + 12 * pos.numel()
    assert nbytes > pos.numel() * 13


def test_locate_work_all_invalid():
    cs = _smoke()
    ix = _index(4, 10)
    pos, _ = _rows(ix, False, 3)
    valid = torch.zeros_like(pos, dtype=torch.uint8)
    walk = cs.locate_walk(ix, pos, valid)
    assert int(walk["steps"].sum()) == 0 and walk["tests"].numel() == 0
    nbytes, _nops, _shape, reads = cs.locate_work(dict(index=ix, pos=pos, valid=valid))
    assert reads == 0 and nbytes == pos.numel() * 13


@pytest.mark.parametrize("Fc,Fe", [(256, 128), (64, 16), (32, 64), (4, 8), (16, 16)])
def test_gather_states_work_counts_plain_bytes(Fc, Fe):
    cs = _smoke()
    rng = np.random.default_rng(Fc + Fe)
    B, npad, n = 300, 40, 29
    st = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (4, B, Fc)).astype(np.int32))
    valid = torch.from_numpy((rng.random((B, Fc)) < 0.5).astype(np.uint8))
    ridx = torch.from_numpy(rng.integers(0, B, npad).astype(np.int32))
    args = dict(st=st, valid=valid, ridx=ridx, n=n, Fe=Fe)
    out, out_valid = kernels.gather_states_plain(**args)
    keep = min(Fc, Fe)
    read = (ridx.numel() * ridx.element_size()
            + st[:, ridx.long(), :keep].numel() * st.element_size()
            + valid[ridx.long(), :keep].numel() * valid.element_size())
    written = out.numel() * out.element_size() + out_valid.numel() * out_valid.element_size()
    nbytes, _nops, shape, _reads = cs.kernel_work("gather_states", args)
    assert nbytes == read + written
    assert f"B={B} Fc={Fc} Fe={Fe}" in shape
    assert cs.variant("gather_states", args) == f"B={B} Fc={Fc} Fe={Fe}"
