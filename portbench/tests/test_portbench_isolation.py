"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: each module of portbench/ imported
alone in a fresh interpreter, top-level module names compared whole."""

import os
import subprocess
import sys

import pytest
from conftest import ROOT

HERE = os.path.join(ROOT, "portbench")


def modules():
    out = []
    for d, _dirs, files in os.walk(HERE):
        if os.path.basename(d) in ("tests", "__pycache__"):
            continue
        for f in sorted(files):
            if f.endswith(".py") and f != "run.py":
                rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3].replace(os.sep, ".")
                out.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(out)


def tops_after_import(module):
    code = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
            "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code, module], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    return set(res.stdout.split())


@pytest.mark.parametrize("module", modules())
def test_no_jax(module):
    tops = tops_after_import(module)
    assert not tops & {"jax", "jaxlib", "flax", "genmap_tpu"}, module
    if module.startswith("portbench.reference"):
        assert "genmap_tpu_torch" not in tops


def test_the_modules_are_all_there():
    mods = modules()
    assert "portbench.program" in mods and "portbench.reference.frequency" in mods
    assert any(m.startswith("portbench.metrics.") for m in mods)


def test_a_run_refuses_without_a_card():
    """run.py exits non-zero and prints no result where CUDA is missing (this
    sandbox) or the port is not beside it."""
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ecoli-k20e1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0
    assert res.stdout.strip() == ""
