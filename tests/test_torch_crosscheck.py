"""Cross-tool validation of genmap_tpu_torch: its bedgraphs against the
independent C++ seed-and-verify counter (tests/crosscheck/crosscheck.cpp),
which shares no code or algorithm with either package.  Byte-equal output
required.  The port maps on the CPU (the kernels' plain versions): (16,0)
on a 150 kbp genome with planted repeats, (20,1) and (30,2) there too
(slow), and the genome-scale script (`genmap_tpu_torch.scripts.
realistic_crosscheck`) at 50 kbp.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from genmap_tpu_torch.cli.main import main
from genmap_tpu_torch.scripts import realistic_crosscheck

torch.set_num_threads(1)

_DIR = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize(
    "K,E",
    [(16, 0), pytest.param(20, 1, marks=pytest.mark.slow),
     pytest.param(30, 2, marks=pytest.mark.slow)],
)
def test_bedgraph_matches_independent_counter(tmp_path, K, E):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the independent counter")
    tmp = str(tmp_path)
    exe = os.path.join(tmp, "crosscheck")
    subprocess.run(["g++", "-O2", "-o", exe,
                    os.path.join(_DIR, "crosscheck", "crosscheck.cpp")], check=True)

    rng = np.random.default_rng(4216)
    n = 150_000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    unit = codes[1000:1060].copy()  # planted repeats: frequencies > 1
    for off in range(5000, 40000, 7000):
        codes[off : off + 60] = unit
    codes[n // 2 : n // 2 + 600] = np.tile(codes[3000:3100], 6)
    codes.tofile(os.path.join(tmp, "codes.bin"))
    bases = np.array([65, 67, 71, 84], np.uint8)[codes]
    with open(os.path.join(tmp, "g.fa"), "wb") as f:
        f.write(b">chrT\n")
        for i in range(0, n, 80):
            f.write(bases[i : i + 80].tobytes() + b"\n")

    out = os.path.join(tmp, "out")
    os.makedirs(out)
    idx = os.path.join(tmp, "idx")
    assert main(["index", "-F", os.path.join(tmp, "g.fa"), "-I", idx]) == 0
    assert main(["map", "-I", idx, "-O", out + "/", "-K", str(K), "-E", str(E),
                 "-fl", "-bg", "--device", "cpu"]) == 0
    ref = os.path.join(tmp, "ref.bedgraph")
    subprocess.run([exe, os.path.join(tmp, "codes.bin"), str(K), str(E), ref, "chrT"],
                   check=True)
    with open(os.path.join(out, "g.genmap.bedgraph"), "rb") as f:
        got = f.read()
    with open(ref, "rb") as f:
        want = f.read()
    assert got == want
    assert b"\t1\n" in got and b"\t6\n" in got  # unique and repeated k-mers


def test_realistic_crosscheck_script(tmp_path, capsys):
    """The genome-scale script's own run, at 50 kbp on the CPU: both
    configurations byte-equal to the counter."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the independent counter")
    rc = realistic_crosscheck.main(["0.05", "--work", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if "byte-equal:" in ln]
    assert len(lines) == 2 and all(ln.endswith("byte-equal: True") for ln in lines), out
    assert "(20,1) 0.05 Mbp" in lines[0] and "(30,2) 0.05 Mbp" in lines[1]
    assert out.splitlines()[-1] == "PASS"


def test_realistic_crosscheck_fails_loudly(tmp_path, monkeypatch, capsys):
    """A counter that fails raises; a bedgraph that differs from the
    counter's makes the script print FAIL and the first differing line, and
    exit non-zero."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the independent counter")
    rcc = realistic_crosscheck
    codes, _fa = rcc.write_corpus(str(tmp_path), 1000)
    bad = rcc.Counter(rcc.build_counter(str(tmp_path)), codes, 21, 1,
                      str(tmp_path / "bad.bedgraph"))  # K % 2 != 0: refused
    with pytest.raises(RuntimeError, match=r"counter at \(21,1\) failed"):
        bad.join()

    orig = rcc.map_config

    def corrupt(*a):
        res = orig(*a)
        with open(res["bedgraph"], "ab") as f:
            f.write(b"chrR\t0\t1\t1\n")
        return res

    monkeypatch.setattr(rcc, "map_config", corrupt)
    work = tmp_path / "work"
    assert rcc.main(["0.02", "--work", str(work), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("byte-equal: False; first difference at line") == 2, out
    assert out.splitlines()[-1] == "FAIL"
