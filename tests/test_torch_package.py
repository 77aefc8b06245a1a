"""genmap_tpu_torch stands alone: no jax, no genmap_tpu, cuda by default.

The import check runs in a subprocess because this test process has jax
loaded already (tests/conftest.py).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "genmap_tpu_torch")

_MODULES = (
    "genmap_tpu_torch",
    "genmap_tpu_torch.cli.main",
    "genmap_tpu_torch.cli.map_cmd",
    "genmap_tpu_torch.cli.index_cmd",
    "genmap_tpu_torch.engine.mappability",
    "genmap_tpu_torch.search.engine",
    "genmap_tpu_torch.kernels",
    "genmap_tpu_torch.tracing",
    "genmap_tpu_torch.ops.rank",
    "genmap_tpu_torch.index.fmindex",
    "genmap_tpu_torch.io.writers",
    "genmap_tpu_torch.parallel.dist",
    "genmap_tpu_torch.parallel.mesh",
    "genmap_tpu_torch.parallel.partmesh",
    "genmap_tpu_torch.parallel.dryrun",
    "genmap_tpu_torch.experiments.row_gather",
    "genmap_tpu_torch.engine.oracle",
    "genmap_tpu_torch.scripts.realistic_crosscheck",
    "genmap_tpu_torch.scripts.hg38_demo",
    "genmap_tpu_torch.scripts.build_probe",
)


@pytest.mark.parametrize("module", _MODULES)
def test_import_leaves_jax_and_genmap_tpu_out(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'genmap_tpu' or m.startswith('genmap_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_jax_or_genmap_tpu():
    pat = re.compile(r"^\s*(from|import)\s+(jax|genmap_tpu)(\.|\s|$)", re.M)
    offenders = []
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    for m in pat.finditer(f.read()):
                        offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def _tiny_data():
    from genmap_tpu_torch.index.build import build_index
    from genmap_tpu_torch.io.fasta import FastaFile

    rng = np.random.default_rng(3)
    ff = FastaFile(name="g.fa")
    ff.ids = ["a"]
    ff.seqs = [rng.integers(0, 4, size=300, dtype=np.uint8)]
    return build_index([ff], sampling=4)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card contract is not testable")
    from genmap_tpu_torch.engine.mappability import MappabilityEngine
    from genmap_tpu_torch.ops.rank import DeviceIndex, DeviceText

    data = _tiny_data()
    with pytest.raises(RuntimeError, match="cuda"):
        MappabilityEngine(data)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceText.from_host(data)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceIndex.from_part(data, data.parts[0])


def test_launch_local_defaults_to_cuda():
    import inspect

    from genmap_tpu_torch.parallel.dist import launch_local

    assert inspect.signature(launch_local).parameters["device"].default == "cuda"


def test_realistic_crosscheck_needs_a_card_unless_told_cpu(tmp_path):
    """Without a card the script raises before it writes anything; with
    `--device cpu` it runs (tests/test_torch_crosscheck.py runs it)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card contract is not testable")
    from genmap_tpu_torch.scripts.realistic_crosscheck import main

    work = tmp_path / "work"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["0.01", "--work", str(work)])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["0.01", "--work", str(work), "--device", "cuda"])
    assert not work.exists()


def test_cli_map_without_card_fails_cleanly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from genmap_tpu_torch.cli.main import main

    fa = tmp_path / "g.fa"
    fa.write_text(">a\nACGTTGCAACGGTACCAGTTAGCATCGATCGGATC\n")
    idx = str(tmp_path / "idx")
    assert main(["index", "-F", str(fa), "-I", idx]) == 0
    out = tmp_path / "out"
    out.mkdir()
    assert main(["map", "-I", idx, "-O", str(out), "-K", "8", "-t"]) == 1
    assert not list(out.iterdir())


def test_cpu_tensors_take_the_plain_versions():
    from genmap_tpu_torch import kernels

    kernels.reset_launches()
    arr = torch.arange(24, dtype=torch.int32).view(2, 3, 4)
    valid = torch.tensor([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1]], dtype=torch.uint8)
    out, v, ovf = kernels.compact(arr, valid, 2)
    assert out[0].tolist() == [[0, 2], [0, 0], [8, 9]]
    assert v.tolist() == [[1, 1], [0, 0], [1, 1]]
    assert ovf.tolist() == [1, 0, 1]
    assert all(n == 0 for n in kernels.launch_counts().values())
