"""The control of `correct`: the plain reference with one guarantee of the
configuration broken, put in the program's place and judged as the
program's files are, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--break errors|strand] [--device cuda|cpu]

`errors` (the default) counts one mismatch fewer than the cell asks for: an
incomplete search, the step that a faster search would be tempted to take;
`strand` leaves out the reverse complements.  For each seed it prints the
number of sampled values in which the control differs from the sound
reference (a sound run reads 0 there), as JSON lines.  The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.genome import make_genome  # noqa: E402
from portbench.harness import (Spec, output_readers, sample_positions,  # noqa: E402
                               selected)
from portbench.reference.frequency import frequencies  # noqa: E402


def control_reading(spec: Spec, seed: int, broken: str = "errors",
                    device: str = "cpu") -> dict:
    """Sampled values in which the control differs from the reference."""
    trf = spec.traffic
    K, E, flags = int(trf["K"]), int(trf["E"]), list(trf["flags"])
    genome = make_genome(spec.config, seed)
    mask = selected(genome, trf.get("selection"), K)
    pos = sample_positions(genome, K, int(trf["check_positions"]), seed, mask)
    cap = 255 if "-fs" in flags else 65535
    rc = "-nc" not in flags
    t = time.perf_counter()
    ref = frequencies(genome.codes, genome.cum, pos, K, E, cap, rc, device=device)
    ref_s = time.perf_counter() - t
    if broken == "errors":
        if E == 0:
            raise ValueError("an exact cell has no search one mismatch short")
        ctl = frequencies(genome.codes, genome.cum, pos, K, E - 1, cap, rc, device=device)
    elif broken == "strand":
        ctl = frequencies(genome.codes, genome.cum, pos, K, E, cap, False, device=device)
    else:
        raise ValueError(f"unknown control {broken!r}")
    wrong = 0
    for mod in output_readers(flags).values():
        wrong += int((mod.expect(ctl, flags) != mod.expect(ref, flags)).sum())
    return dict(seed=seed, control=broken, positions=len(pos), wrong_values=wrong,
                reference_s=ref_s)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--break", dest="broken", default="errors", choices=("errors", "strand"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = Spec.load(args.workload)
    for seed in args.seeds:
        print(json.dumps(dict(workload=args.workload,
                              **control_reading(spec, seed, args.broken, args.device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
