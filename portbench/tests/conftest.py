"""Shared pieces of the benchmark's CPU tests: a tiny cell whose genome
holds every kind of repeat class, run on the port's plain (CPU) versions."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the port's plain versions on few threads: test workers share the cores
torch.set_num_threads(2)


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_config(lens=(9000, 7000, 4000)):
    repeats = [
        {"name": "young", "kind": "interspersed", "share": 0.4, "consensus_bp": 400,
         "copy_bp": 300, "families": 3, "divergence": [0.0, 0.03]},
        {"name": "old", "kind": "interspersed", "share": 0.2, "consensus_bp": 2000,
         "copy_bp": 250, "families": 1, "divergence": [0.1, 0.3]},
        {"name": "simple", "kind": "tandem", "share": 0.03, "unit_bp": [1, 6],
         "copy_bp": [20, 120], "divergence": [0.0, 0.1]},
        {"name": "segdup", "kind": "duplication", "share": 0.05, "copy_bp": [200, 800],
         "divergence": [0.0, 0.02]},
    ]
    return {"sequences": [[f"s{i}", n] for i, n in enumerate(lens)],
            "genome_bp": sum(lens), "sampling": 10, "gc": 0.45, "family_seed": 2026,
            "repeats": repeats}


def tiny_spec(bench, K=20, E=1, flags=("-fl", "-bg"), positions=3000, selection=None):
    from portbench.harness import Spec

    traffic = {"K": K, "E": E, "flags": list(flags), "selection": selection,
               "check_positions": positions}
    cell = {"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1}
    return Spec.of(bench, cell, tiny_config(), traffic)
