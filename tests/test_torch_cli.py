"""`genmap-tpu-torch index|map` against `genmap-tpu index|map`, byte for byte.

The FASTA is generated here from a numpy seed.  The port maps with
`--device cpu` (the kernels' plain versions); the JAX CLI runs on the CPU as
tests/conftest.py sets it up.
"""

import os

import numpy as np
import pytest
import torch

from genmap_tpu.cli.main import main as jax_main
from genmap_tpu_torch.cli.main import main as torch_main

torch.set_num_threads(1)

_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _write_fasta(path, seed=5):
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 90)
    chroms = {
        "chr1 first chromosome": np.concatenate(
            [rng.integers(0, 4, 700), np.tile(unit, 5), rng.integers(0, 4, 300)]),
        "chr2": np.concatenate([rng.integers(0, 4, 400), np.full(25, 4),
                                rng.integers(0, 5, 350)]),
        "chr3": rng.integers(0, 4, 60),
    }
    with open(path, "w") as f:
        for name, codes in chroms.items():
            s = _ACGTN[codes].tobytes().decode()
            f.write(f">{name}\n")
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")


def _tree(d):
    out = {}
    for dirpath, _dirs, files in os.walk(d):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    fa = str(root / "genome.fa")
    _write_fasta(fa)
    jidx, tidx = str(root / "jidx"), str(root / "tidx")
    assert jax_main(["index", "-F", fa, "-I", jidx, "-S", "4"]) == 0
    assert torch_main(["index", "-F", fa, "-I", tidx, "-S", "4"]) == 0
    return root, jidx, tidx


def test_index_directory_is_byte_equal(indexes):
    _root, jidx, tidx = indexes
    j, t = _tree(jidx), _tree(tidx)
    assert sorted(j) == sorted(t)
    for name in j:
        assert j[name] == t[name], name


_FLAG_SETS = {
    "mappability_all_formats": ["-K", "20", "-E", "2", "-r", "-t", "-w", "-bg", "-b"],
    "freq_small": ["-K", "20", "-E", "2", "-fs", "-r", "-t"],
    "freq_large_nc": ["-K", "20", "-E", "2", "-fl", "-nc", "-r", "-bg", "-w"],
    "selection": ["-K", "20", "-E", "2", "-t", "-w", "-b", "-S", "{bed}"],
    "csv": ["-K", "20", "-E", "2", "-d", "-t"],
    "csv_nc": ["-K", "16", "-E", "1", "-d", "-nc", "-fl", "-r"],
    "csv_selection": ["-K", "20", "-E", "2", "-d", "-fl", "-t", "-S", "{bed}"],
}


def _map_both(root, jidx, tidx, name, argv):
    jout, tout = root / f"j_{name}", root / f"t_{name}"
    jout.mkdir()
    tout.mkdir()
    assert jax_main(["map", "-I", jidx, "-O", str(jout), *argv]) == 0
    assert torch_main(["map", "-I", tidx, "-O", str(tout), *argv, "--device", "cpu"]) == 0
    j, t = _tree(jout), _tree(tout)
    assert j and sorted(j) == sorted(t)
    for fn in j:
        assert j[fn] == t[fn], fn
    return t


@pytest.mark.parametrize("flags", sorted(_FLAG_SETS))
def test_map_outputs_are_byte_equal(indexes, flags):
    root, jidx, tidx = indexes
    bed = root / "sel.bed"
    bed.write_text("chr1\t5\t400\nchr2\t380\t600\nchr1\t900\t960\n")
    argv = [a.replace("{bed}", str(bed)) for a in _FLAG_SETS[flags]]
    t = _map_both(root, jidx, tidx, flags, argv)
    if "-d" in argv:
        csv = t["genome.genmap.csv"].decode()
        assert csv.count("\n") > 100 and "|" in csv  # repeats list several locations


@pytest.fixture(scope="module")
def dir_indexes(tmp_path_factory):
    """A directory of three FASTA files that share a 300 bp segment (one
    copy reverse-complemented), indexed by both CLIs with -FD."""
    root = tmp_path_factory.mktemp("cli_dir")
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 4, 300)
    files = {
        "a.fa": {"a1": np.concatenate([rng.integers(0, 4, 200), shared,
                                       rng.integers(0, 4, 150)]),
                 "a2": rng.integers(0, 4, 120)},
        "b.fa": {"b1": np.concatenate([rng.integers(0, 4, 90), (3 - shared)[::-1],
                                       rng.integers(0, 4, 60)])},
        "c.fa": {"c1": np.concatenate([rng.integers(0, 4, 50), shared,
                                       rng.integers(0, 5, 100)])},
    }
    fdir = root / "fasta"
    fdir.mkdir()
    for fn, chroms in files.items():
        with open(fdir / fn, "w") as f:
            for name, codes in chroms.items():
                f.write(f">{name}\n{_ACGTN[codes].tobytes().decode()}\n")
    jidx, tidx = str(root / "jidx"), str(root / "tidx")
    assert jax_main(["index", "-FD", str(fdir), "-I", jidx, "-S", "3"]) == 0
    assert torch_main(["index", "-FD", str(fdir), "-I", tidx, "-S", "3"]) == 0
    return root, jidx, tidx


_EP_FLAG_SETS = {
    "ep": ["-K", "24", "-E", "1", "-ep", "-fl", "-t"],
    "ep_nc": ["-K", "24", "-E", "1", "-ep", "-nc", "-fl", "-r"],
    "ep_csv": ["-K", "24", "-E", "1", "-d", "-ep", "-fl", "-t"],
}


@pytest.mark.parametrize("flags", sorted(_EP_FLAG_SETS))
def test_exclude_pseudo_outputs_are_byte_equal(dir_indexes, flags):
    root, jidx, tidx = dir_indexes
    t = _map_both(root, jidx, tidx, flags, _EP_FLAG_SETS[flags])
    assert sorted(t) == sorted(
        f"{b}.genmap.{x}" for b in "abc"
        for x in (["txt"] if "-t" in _EP_FLAG_SETS[flags] else ["freq16"])
        + (["csv"] if "-d" in _EP_FLAG_SETS[flags] else [])
    )
    if flags != "ep_nc":  # the shared segment occurs in all three files
        assert b"\t3" in t["c.genmap.txt"] or b" 3" in t["c.genmap.txt"]


@pytest.fixture(scope="module")
def multipart_indexes(indexes, dir_indexes):
    """The genome and the FASTA directory above, indexed again by both CLIs
    with the part size capped (-xm): 2 and 3 parts."""
    out = {}
    for name, (root, _j, _t), src, xm in (("genome", indexes, ["-F", "genome.fa"], "2950"),
                                          ("dir", dir_indexes, ["-FD", "fasta"], "1400")):
        src = [src[0], str(root / src[1])]
        jidx, tidx = str(root / "jidx_mp"), str(root / "tidx_mp")
        assert jax_main(["index", *src, "-I", jidx, "-S", "3", "-xm", xm]) == 0
        assert torch_main(["index", *src, "-I", tidx, "-S", "3", "-xm", xm]) == 0
        out[name] = (root, jidx, tidx)
    return out


def test_multipart_index_directories_are_byte_equal(multipart_indexes):
    for name, nparts in (("genome", 2), ("dir", 3)):
        _root, jidx, tidx = multipart_indexes[name]
        j, t = _tree(jidx), _tree(tidx)
        assert sorted(j) == sorted(t)
        assert sum(fn.endswith("_dimer.npy") for fn in t) == nparts, sorted(t)
        for fn in j:
            assert j[fn] == t[fn], fn


_MP_FLAG_SETS = {
    "freq_large": ("genome", ["-K", "20", "-E", "2", "-fl", "-r", "-t"]),
    "csv": ("genome", ["-K", "20", "-E", "2", "-d", "-t"]),
    "ep_csv": ("dir", ["-K", "24", "-E", "1", "-d", "-ep", "-fl", "-t"]),
}


@pytest.mark.parametrize("flags", sorted(_MP_FLAG_SETS))
def test_multipart_map_outputs_are_byte_equal(multipart_indexes, flags):
    which, argv = _MP_FLAG_SETS[flags]
    root, jidx, tidx = multipart_indexes[which]
    t = _map_both(root, jidx, tidx, f"mp_{flags}", argv)
    if "-d" in argv:  # locations in more than one part
        csv = b"".join(v for k, v in t.items() if k.endswith(".csv")).decode()
        assert csv.count("\n") > 100 and ("|" in csv or "-ep" in argv)
