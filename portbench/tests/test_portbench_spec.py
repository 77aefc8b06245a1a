"""Everything BENCHMARK.json names is found by name under portbench/."""

import json
import os

from conftest import ROOT

from portbench.harness import Spec, load_module, output_readers


def test_cells_find_their_configuration_and_traffic(bench):
    for cell in bench["workloads"]:
        spec = Spec.load(cell["name"])
        assert spec.traffic["name"] == cell["traffic"]
        assert spec.config["name"] == cell["config"]
        assert sum(n for _s, n in spec.config["sequences"]) == spec.config["genome_bp"]
        assert output_readers(spec.traffic["flags"])


def test_every_metric_has_its_module(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load_module("metrics", m["name"]).read)


def test_reduced_keys_are_the_configuration_files(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])


def test_each_cell_reports_its_metrics(bench):
    for cell in bench["workloads"]:
        spec = Spec.load(cell["name"])
        e2e = {m["name"] for m in spec.metrics(False)}
        assert {"kmers_per_s", "setup_s"} <= e2e
        assert len(spec.metrics(True)) == len(bench["per_layer"])
