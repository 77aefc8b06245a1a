#!/usr/bin/env python3
"""A/B timing of whole-genome maps on one GPU.

    python3 chip_ab.py OTHER_CHECKOUT [--runs N] [--busy]
    python3 chip_ab.py --dimer [--runs N] [--busy]

Builds chip_smoke.py's 12.07 Mbp genome-like genome and its index once,
then maps it with `genmap-tpu-torch map -K k -E e -fl -r` on the card from
separate processes.  With OTHER_CHECKOUT, at (100,2) in the order A, B, C,
C, B, A, then at (24,1) in the order A, B, B, A:

  A  the genmap_tpu_torch of OTHER_CHECKOUT (e.g. the parent commit,
     unpacked with `git archive`)
  B  this checkout's
  C  this checkout's with the unique-infix probe turned off

With --dimer, this checkout's engine with its dimer-tier policy as by
default (A: dimer_tier=None, tier 0 on the dimer rows where the pool
schedule is wide, twins before the wide exact tiers) against
dimer_tier=False (B: mono rows only), in the order A, B, B, A, at (100,2)
and then at (24,1).

Each process builds its kernels, maps once to warm up, then maps N times
(default 3); it reports the compute time of each run (`map`'s own
compute_s: index upload and seed tables excluded), the engine's dispatch /
fetch seconds, batches, blocks per tier, kernel launches, peak allocated
device bytes and its frequencies' checksum, which must agree across all
processes of one configuration.  With --busy, one more map under
torch.profiler gives the device-busy share of a whole map (kernel time
over wall time, the profiler's overhead included in the wall time; it
takes minutes per process at (100,2)).  Printed last: one JSON object with
every process's numbers and the card's name and power limit.  Needs one
CUDA card and nvcc.
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
dimer, k, e, busy = sys.argv[6], sys.argv[7], sys.argv[8], sys.argv[9] == "1"
sys.path.insert(0, root)
import numpy as np, torch
torch.set_num_threads(min(8, os.cpu_count() or 1))
from genmap_tpu_torch import kernels
from genmap_tpu_torch.cli.map_cmd import map_main
from genmap_tpu_torch.engine.mappability import MappabilityEngine
init = MappabilityEngine.__init__
def configured(self, *a, **kw):
    init(self, *a, **kw)
    self._probe_enabled = probe
    if dimer == "off":
        self._dimer_mode = False
MappabilityEngine.__init__ = configured
kernels.build()
res = []
argv = ["-I", idx, "-K", k, "-E", e, "-fl", "-r", "--device", "cuda"]
for i in range(runs + 1):
    o = os.path.join(out, str(i))
    os.makedirs(o)
    report = {}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    if map_main(argv + ["-O", o + "/"], report=report) != 0:
        sys.exit(1)
    torch.cuda.synchronize()
    with open(os.path.join(o, "yeastlike.genmap.freq16"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    st = report["stats"]
    if i:
        res.append(dict(compute_s=report["compute_s"], n_kmers=report["n_kmers"],
                        dispatch_s=st["dispatch_s"], fetch_s=st["fetch_s"],
                        batches=st["batches"], sha=digest,
                        dimer_tier=st.get("dimer_tier"),
                        tier_blocks={str(t): n for t, n in st["tier_blocks"].items()},
                        probe_skipped=st["probe_skipped"],
                        launches=sum(kernels.launch_counts().values()),
                        peak_bytes=torch.cuda.max_memory_allocated()))
share = None
if busy:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import time
    o = os.path.join(out, "profiled")
    os.makedirs(o)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        map_main(argv + ["-O", o + "/"], report={})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_s = sum((getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0))
                for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA) / 1e6
    share = dev_s / wall if dev_s > 0 else None
for r in res:
    r["busy_share"] = share
print(json.dumps(res))
"""


def run_order(work, idx, order, runs, k, e, tag, busy):
    """Run the processes of `order` ((key, root, probe, dimer) each) at
    (k, e); returns {key: [run, ...]}, or None when one fails."""
    results = {}
    for n, (key, root, probe, dimer) in enumerate(order):
        out = os.path.join(work, f"{tag}_out{n}")
        os.makedirs(out)
        r = subprocess.run([sys.executable, "-c", CHILD, root, idx, out, str(runs),
                            probe, dimer, str(k), str(e), str(int(busy))],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return None
        rs = json.loads(r.stdout.strip().splitlines()[-1])
        results.setdefault(key, []).extend(rs)
        kps = [x["n_kmers"] / x["compute_s"] for x in rs]

        def col(vals, fmt):
            return ", ".join(format(v, fmt) for v in vals)

        mode = (f"probe {'on' if probe == '1' else 'off'}, dimer {dimer}")
        print(f"({k},{e}) {key} ({mode}, {root}): k-mers/s {col(kps, '.0f')}; dispatch "
              f"{col([x['dispatch_s'] for x in rs], '.2f')} s; fetch "
              f"{col([x['fetch_s'] for x in rs], '.2f')} s; batches "
              f"{rs[0]['batches']}; launches {rs[0]['launches']}; peak allocated "
              f"{rs[0]['peak_bytes']} B; device busy (profiled map) {rs[0]['busy_share']}; "
              f"dimer tier 0 {rs[0]['dimer_tier']}; blocks per "
              f"tier {rs[0]['tier_blocks']}; probe skipped {rs[0]['probe_skipped']}",
              flush=True)
    shas = {x["sha"] for rs in results.values() for x in rs}
    if len(shas) != 1:
        print(f"({k},{e}): frequencies differ between processes: {shas}", file=sys.stderr)
        return None
    return results


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("other", nargs="?")
    p.add_argument("--dimer", action="store_true",
                   help="dimer tiers as by default against mono rows only")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--busy", action="store_true",
                   help="also profile one map per process (device-busy share)")
    args = p.parse_args()
    if args.dimer == (args.other is not None):
        p.error("give either OTHER_CHECKOUT or --dimer")
    sys.path.insert(0, HERE)
    import chip_smoke
    from genmap_tpu_torch.cli.main import main as cli_main

    summary = {}
    with tempfile.TemporaryDirectory(prefix="genmap_ab_") as work:
        fa = os.path.join(work, "yeastlike.fa")
        chip_smoke.write_fasta(fa, chip_smoke.yeast_like_genome())
        idx = os.path.join(work, "idx")
        if cli_main(["index", "-F", fa, "-I", idx]) != 0:
            return 1
        if args.dimer:
            order = [("A", HERE, "1", "auto"), ("B", HERE, "1", "off")]
            cells = [(100, 2, order + order[::-1]), (24, 1, order + order[::-1])]
        else:
            order = [("A", os.path.abspath(args.other), "1", "auto"),
                     ("B", HERE, "1", "auto"), ("C", HERE, "0", "auto")]
            # (24,1) runs no probe (J = 6): C would equal B there
            cells = [(100, 2, order + order[::-1]), (24, 1, order[:2] + order[1::-1])]
        for k, e, cell_order in cells:
            results = run_order(work, idx, cell_order, args.runs, k, e, f"{k}_{e}",
                                args.busy)
            if results is None:
                return 1
            summary[f"{k},{e}"] = {
                key: dict(kmers_per_s_median=float(np.median(
                    [x["n_kmers"] / x["compute_s"] for x in rs])), runs=rs)
                for key, rs in results.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    summary["card"] = smi.stdout.strip()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
