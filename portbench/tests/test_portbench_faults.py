"""A run with the timed path broken underneath comes out as not correct;
the same run unbroken is correct.  The run's look for a card is skipped: the
port runs its plain versions on the CPU at a tiny size."""

import json
import time

import numpy as np
import pytest
import torch
from conftest import tiny_spec

from genmap_tpu_torch.cli import map_cmd
from genmap_tpu_torch.engine.mappability import MappabilityEngine
from portbench.harness import Spec, result_line, run_cell

FAULTS = ["unchanged", "half", "altered", "one strand", "no output"]


def run(spec, seed=2**31 + 99, device="cpu", seconds=0.5):
    out = run_cell(spec, seed, seconds, False, device, time.perf_counter(), log=lambda m: None)
    return result_line(spec, out, False, device, 1)


def broken(monkeypatch, fault):
    orig = MappabilityEngine.compute_file
    if fault == "no output":  # the job returns 0 and writes nothing
        for w in ("save_raw", "save_bedgraph"):
            monkeypatch.setattr(map_cmd, w, lambda *a, **kw: None)
        return

    def compute_file(self, layout, params, *a, **kw):
        if fault == "one strand":  # an answer altered where it is produced
            params = type(params)(**{**params.__dict__, "rev_compl": False})
        res = orig(self, layout, params, *a, **kw)
        c = res.c
        if fault == "unchanged":  # the map returns its counts as it set them up
            c[:] = 0
        elif fault == "half":  # half of the k-mers left out
            c[len(c) // 2:] = 0
        elif fault == "altered":  # some answers altered
            c[::97] = np.minimum(c[::97] + 1, 255)
        return res

    monkeypatch.setattr(MappabilityEngine, "compute_file", compute_file)


@pytest.mark.parametrize("flags", [("-fs", "-r", "-m"), ("-fl", "-bg")])
def test_sound_run_is_correct(bench, flags):
    line = run(tiny_spec(bench, 30, 2, flags))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"kmers_per_s", "setup_s"}


@pytest.mark.parametrize("genome_seed", [1, 2, 3])
def test_sound_runs_on_several_genomes(bench, genome_seed):
    """A configuration with one genome is judged on that genome alone: runs
    on other genome seeds come out correct too."""
    spec = tiny_spec(bench, 30, 2, ("-fs", "-r", "-m"))
    spec.config = dict(spec.config, genome_seed=genome_seed)
    line = run(spec)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("flags", [("-fs", "-r", "-m"), ("-fl", "-bg")])
def test_broken_run_is_not_correct(bench, monkeypatch, fault, flags):
    spec = tiny_spec(bench, 30, 2, flags)
    broken(monkeypatch, fault)
    line = run(spec)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_at_cell_size(bench, monkeypatch, fault):
    """Each fault on the card, in each cell at its own size, one job on
    three seeds: the readings that the limits' upper ends come from."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    broken(monkeypatch, fault)
    for cell in bench["workloads"]:
        spec = Spec.load(cell["name"])
        for seed in (61, 62, 63):
            line = run(spec, seed, "cuda", 0.1)
            print(json.dumps(dict(cell=cell["name"], fault=fault, seed=seed,
                                  checks=line["checks"])), flush=True)
            assert not line["correct"]


@pytest.mark.parametrize("flags,selection", [
    (("-r", "-bg"), None),  # mappability (1/frequency) in both readers
    (("-fl", "-r"), [["s0", 100, 2500], ["s2", 0, 3900]]),  # a BED selection
])
def test_sound_run_of_other_outputs_is_correct(bench, flags, selection):
    line = run(tiny_spec(bench, 24, 1, flags, selection=selection))
    assert line["correct"], line["checks"]
