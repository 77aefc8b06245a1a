#!/usr/bin/env python3
"""A/B timing of the whole-genome (100,2) map on one GPU, two checkouts.

    python3 chip_ab.py OTHER_CHECKOUT [--runs N]

Builds chip_smoke.py's 12.07 Mbp genome-like genome and its index once,
then maps it with `genmap-tpu-torch map -K 100 -E 2 -fl -r` on the card from
separate processes, in the order A, B, C, C, B, A:

  A  the genmap_tpu_torch of OTHER_CHECKOUT (e.g. the parent commit,
     unpacked with `git archive`)
  B  this checkout's
  C  this checkout's with the unique-infix probe turned off

Each process builds its kernels, maps once to warm up, then maps N times
(default 3); it reports the compute time of each run (`map`'s own
compute_s: index upload and seed tables excluded), the engine's dispatch /
fetch seconds and its frequencies' checksum, which must agree across all
processes.  Printed last: one JSON object with every process's numbers and
the card's name and power limit.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import hashlib, json, os, sys
root, idx, out, runs, probe = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5] == "1"
sys.path.insert(0, root)
import numpy as np, torch
torch.set_num_threads(min(8, os.cpu_count() or 1))
from genmap_tpu_torch import kernels
from genmap_tpu_torch.cli.map_cmd import map_main
from genmap_tpu_torch.engine.mappability import MappabilityEngine
if not probe:
    init = MappabilityEngine.__init__
    def no_probe(self, *a, **k):
        init(self, *a, **k)
        self._probe_enabled = False
    MappabilityEngine.__init__ = no_probe
kernels.build()
res = []
for i in range(runs + 1):
    o = os.path.join(out, str(i))
    os.makedirs(o)
    report = {}
    if map_main(["-I", idx, "-O", o + "/", "-K", "100", "-E", "2", "-fl", "-r",
                 "--device", "cuda"], report=report) != 0:
        sys.exit(1)
    torch.cuda.synchronize()
    with open(os.path.join(o, "yeastlike.genmap.freq16"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    st = report["stats"]
    if i:
        res.append(dict(compute_s=report["compute_s"], n_kmers=report["n_kmers"],
                        dispatch_s=st["dispatch_s"], fetch_s=st["fetch_s"],
                        batches=st["batches"], sha=digest))
print(json.dumps(res))
"""


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("other")
    p.add_argument("--runs", type=int, default=3)
    args = p.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    from genmap_tpu_torch.cli.main import main as cli_main

    other = os.path.abspath(args.other)
    with tempfile.TemporaryDirectory(prefix="genmap_ab_") as work:
        fa = os.path.join(work, "yeastlike.fa")
        chip_smoke.write_fasta(fa, chip_smoke.yeast_like_genome())
        idx = os.path.join(work, "idx")
        if cli_main(["index", "-F", fa, "-I", idx]) != 0:
            return 1
        order = [("A", other, "1"), ("B", HERE, "1"), ("C", HERE, "0")]
        order = order + order[::-1]
        results = {k: [] for k, _, _ in order[:3]}
        for n, (key, root, probe) in enumerate(order):
            out = os.path.join(work, f"out{n}")
            os.makedirs(out)
            r = subprocess.run([sys.executable, "-c", CHILD, root, idx, out,
                                str(args.runs), probe],
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
                return 1
            runs = json.loads(r.stdout.strip().splitlines()[-1])
            results[key].extend(runs)
            kps = [x["n_kmers"] / x["compute_s"] for x in runs]

            def col(vals, fmt):
                return ", ".join(format(v, fmt) for v in vals)

            mode = "probe on" if probe == "1" else "probe off"
            print(f"{key} ({mode}, {root}): k-mers/s {col(kps, '.0f')}; dispatch "
                  f"{col([x['dispatch_s'] for x in runs], '.2f')} s; fetch "
                  f"{col([x['fetch_s'] for x in runs], '.2f')} s; batches "
                  f"{runs[0]['batches']}", flush=True)
    shas = {x["sha"] for rs in results.values() for x in rs}
    if len(shas) != 1:
        print(f"frequencies differ between checkouts: {shas}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    summary = {k: dict(kmers_per_s_median=float(np.median(
        [x["n_kmers"] / x["compute_s"] for x in rs])), runs=rs)
        for k, rs in results.items()}
    summary["card"] = smi.stdout.strip()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
