"""Cross-tool validation of genmap_tpu_torch: its (16,0) bedgraph against the
independent C++ seed-and-verify counter (tests/crosscheck/crosscheck.cpp),
which shares no code or algorithm with either package.  Byte-equal output
required.  The port maps on the CPU (the kernels' plain versions).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from genmap_tpu_torch.cli.main import main

torch.set_num_threads(1)

_DIR = os.path.dirname(os.path.abspath(__file__))


def test_bedgraph_matches_independent_counter(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the independent counter")
    tmp = str(tmp_path)
    exe = os.path.join(tmp, "crosscheck")
    subprocess.run(["g++", "-O2", "-o", exe,
                    os.path.join(_DIR, "crosscheck", "crosscheck.cpp")], check=True)

    K, E = 16, 0
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
