"""The control comes out as not correct, at a size a test run holds; on the
card, at the cells' own sizes."""

import json

import pytest
import torch
from conftest import tiny_spec

from portbench.control import control_reading
from portbench.harness import Spec


@pytest.mark.parametrize("K,E,flags", [(20, 1, ("-fl", "-bg")), (30, 2, ("-fs", "-r"))])
@pytest.mark.parametrize("broken", ["errors", "strand"])
def test_control_fails_at_small_size(bench, K, E, flags, broken):
    spec = tiny_spec(bench, K, E, flags, positions=4000)
    for seed in (1, 2, 3):
        assert control_reading(spec, seed, broken)["wrong_values"] > 0


@pytest.mark.cuda
def test_control_fails_at_cell_size(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in bench["workloads"]:
        spec = Spec.load(cell["name"])
        for broken in ("errors", "strand"):
            for seed in (11, 12, 13):
                reading = control_reading(spec, seed, broken, "cuda")
                print(json.dumps(dict(cell=cell["name"], **reading)), flush=True)
                assert reading["wrong_values"] > 0
