"""Genome-scale cross-check of genmap_tpu_torch against an independent counter.

    python -m genmap_tpu_torch.scripts.realistic_crosscheck [mbp] [--work DIR] [--device cuda]

The port's counterpart of the JAX package's `scripts/realistic_crosscheck.py`.
A genome-like corpus (`corpus.make_genomelike(mbp * 1e6, seed=7)`, one
sequence `chrR`, default 50 Mbp) is written as `codes.bin` and FASTA; the
independent C++ pigeonhole counter (`tests/crosscheck/crosscheck.cpp`, no
code or algorithm shared with either package; built with
`g++ -O2 -march=native`) counts its (20,1) and (30,2) frequencies in two
processes started before the index build, so that their CPU time overlaps
the card's work; `genmap-tpu-torch index`, then `map -K 20 -E 1 -fl -bg` and
`map -K 30 -E 2 -fl -bg` on the device, and each bedgraph must be
byte-equal to the counter's.

Printed: the card's name and power limit (nvidia-smi), the index build's
seconds, and one line per configuration with the map's compute seconds and
k-mers/s (the engine's figures, upload excluded) beside its wall seconds,
its route (J, the tier ladder, the dimer tier 0, split or fused pipeline)
and launches per kernel, the counter's seconds, both bedgraphs' line counts
and sha256, `byte-equal: True/False` and the first line that differs.  Last
`PASS` or `FAIL`.  Every stage runs afresh: nothing cached is reused.  The
exit code is non-zero on any difference and on any failed stage (no card
for `--device cuda`, no nvcc or g++, a counter that fails).

The device is cuda unless `--device cpu` is given (the kernels' plain
versions).  The work directory (default
`~/.cache/genmap_tpu_torch/realistic_{mbp}`) holds the corpus, the index,
the counter and both sides' bedgraphs; the runs overwrite what an earlier
run left there.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COUNTER_SRC = os.path.join(ROOT, "tests", "crosscheck", "crosscheck.cpp")
CONFIGS = ((20, 1), (30, 2))
CHROM = "chrR"
SEED = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if device == "cpu":
        return "no GPU (device cpu)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def write_corpus(work: str, n: int) -> tuple[str, str]:
    """`make_genomelike(n, seed=7)` as `codes.bin` (a byte per base, 0..3)
    and `g.fa` (one sequence chrR, 80 bases a line)."""
    from genmap_tpu_torch.corpus import make_genomelike

    codes = make_genomelike(n, seed=SEED)
    codes_path = os.path.join(work, "codes.bin")
    fa_path = os.path.join(work, "g.fa")
    codes.tofile(codes_path)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    full = n // 80 * 80
    lines = np.full((n // 80, 81), ord("\n"), dtype=np.uint8)
    lines[:, :80] = bases[:full].reshape(-1, 80)
    with open(fa_path, "wb") as f:
        f.write(f">{CHROM}\n".encode())
        f.write(lines.tobytes())
        if n > full:
            f.write(bases[full:].tobytes() + b"\n")
    return codes_path, fa_path


def build_counter(work: str) -> str:
    """Compile the independent counter; raises without g++."""
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found: the independent counter cannot be built")
    if not os.path.exists(COUNTER_SRC):
        raise RuntimeError(f"the counter's source {COUNTER_SRC} is missing")
    exe = os.path.join(work, "crosscheck")
    subprocess.run(["g++", "-O2", "-march=native", "-o", exe, COUNTER_SRC], check=True)
    return exe


class Counter:
    """One run of the counter in a process of its own, started at once; a
    thread waits for it, so `seconds` is its own wall time however late
    `join` is called."""

    def __init__(self, exe: str, codes_path: str, K: int, E: int, out: str):
        self.K, self.E, self.out = K, E, out
        self.seconds = None
        self.error = None
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [exe, codes_path, str(K), str(E), out, CHROM],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self):
        out = self.proc.communicate()[0].decode(errors="replace")
        self.seconds = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            self.error = f"exit {self.proc.returncode}: {out[-2000:]}"

    def join(self) -> float:
        """Wait for the counter; raises if it failed.  Returns its seconds."""
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(f"the counter at ({self.K},{self.E}) failed: {self.error}")
        return self.seconds

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.thread.join()


def start_counters(exe: str, codes_path: str, work: str) -> dict:
    """The counter's runs at CONFIGS, all started together."""
    return {(K, E): Counter(exe, codes_path, K, E,
                            os.path.join(work, f"ref_{K}_{E}.bedgraph"))
            for K, E in CONFIGS}


def build_index(fa_path: str, idx: str) -> float:
    """`genmap-tpu-torch index -F fa -I idx`; returns its seconds."""
    from genmap_tpu_torch.cli.main import main as cli_main

    if os.path.exists(idx):
        shutil.rmtree(idx)
        log(f"# index: removed the index an earlier run left at {idx}")
    t = time.perf_counter()
    if cli_main(["index", "-F", fa_path, "-I", idx]) != 0:
        raise RuntimeError("genmap-tpu-torch index failed")
    return time.perf_counter() - t


def route(stats: dict, J: int) -> str:
    """J, the tier ladder (f_search/f_extend, d: dimer rows, x: exact infix),
    the dimer tier 0, and split or fused pipeline of an engine's last map
    (its `stats`)."""
    ladder = " ".join(f"{i}:{t.f_search}/{t.f_extend}{'d' if t.dimer else ''}"
                      f"{'x' if t.exact else ''}" for i, t in enumerate(stats["tiers"]))
    pipe = (f"split ({stats['phase_a_batches']} phase-A, "
            f"{sum(stats['rung_batches'].values())} phase-B batches)"
            if stats["phase_a_batches"] else "fused")
    return (f"J={J} ladder {ladder} dimer_tier={stats['dimer_tier']} {pipe}; "
            f"blocks per tier {stats['tier_blocks']}, probe skipped {stats['probe_skipped']}")


def map_config(idx: str, out: str, K: int, E: int, device: str) -> dict:
    """`genmap-tpu-torch map -K K -E E -fl -bg` with the launch counters set
    to 0 just before and read just after.  Returns the map's report, its
    wall seconds, the launches and the bedgraph's path."""
    import torch

    from genmap_tpu_torch import kernels
    from genmap_tpu_torch.cli.map_cmd import map_main

    os.makedirs(out, exist_ok=True)
    bg = os.path.join(out, "g.genmap.bedgraph")
    if os.path.exists(bg):
        os.remove(bg)
    report = {}
    kernels.reset_launches()
    t = time.perf_counter()
    rc = map_main(["-I", idx, "-O", out + "/", "-K", str(K), "-E", str(E),
                   "-fl", "-bg", "--device", device], report=report)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {n: c for n, c in kernels.launch_counts().items() if c}
    if rc != 0:
        raise RuntimeError(f"genmap-tpu-torch map -K {K} -E {E} exited {rc}")
    return dict(report=report, wall=wall, launches=launches, bedgraph=bg)


def compare(got_path: str, want_path: str) -> dict:
    """Byte comparison of two bedgraphs: equal, line counts, sha256 and the
    first line that differs."""
    with open(got_path, "rb") as f:
        got = f.read()
    with open(want_path, "rb") as f:
        want = f.read()
    gl, wl = got.splitlines(), want.splitlines()
    first = None
    if got != want:
        for i in range(max(len(gl), len(wl))):
            a = gl[i] if i < len(gl) else b"<end>"
            b = wl[i] if i < len(wl) else b"<end>"
            if a != b:
                first = (i, a.decode(errors="replace"), b.decode(errors="replace"))
                break
    return dict(equal=got == want, lines=(len(gl), len(wl)),
                sha256=(hashlib.sha256(got).hexdigest(), hashlib.sha256(want).hexdigest()),
                first_diff=first)


def config_line(K: int, E: int, label: str, res: dict, counter_s: float, cmp: dict) -> str:
    from genmap_tpu_torch.cli.map_cmd import default_overlap

    rep = res["report"]
    J = min(default_overlap(K, E), K - 1, K - E - 2) + 1
    kps = rep["n_kmers"] / rep["compute_s"] if rep["compute_s"] else float("nan")
    diff = ("" if cmp["first_diff"] is None else
            "; first difference at line {}: port {!r}, counter {!r}".format(*cmp["first_diff"]))
    return (f"# ({K},{E}) {label}: map compute {rep['compute_s']:.3f} s, {kps:,.0f} k-mers/s "
            f"({rep['n_kmers']} k-mers), wall {res['wall']:.3f} s; route "
            f"{route(rep['stats'], J)}; launches {res['launches']}; counter {counter_s:.1f} s; "
            f"bedgraph lines {cmp['lines'][0]} / {cmp['lines'][1]}, sha256 "
            f"{cmp['sha256'][0]} / {cmp['sha256'][1]}; byte-equal: {cmp['equal']}{diff}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m genmap_tpu_torch.scripts.realistic_crosscheck")
    p.add_argument("mbp", nargs="?", type=float, default=50.0,
                   help="genome size in Mbp (default 50)")
    p.add_argument("--work", default=None,
                   help="work directory (default ~/.cache/genmap_tpu_torch/realistic_{mbp})")
    p.add_argument("--device", default="cuda",
                   help="torch device of the map (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    from genmap_tpu_torch.hostmem import retain_heap
    from genmap_tpu_torch.ops.rank import resolve_device

    device = resolve_device(args.device).type  # raises without a card
    retain_heap()
    label = f"{args.mbp:g} Mbp"
    n = int(round(args.mbp * 1e6))
    work = args.work or os.path.expanduser(
        f"~/.cache/genmap_tpu_torch/realistic_{args.mbp:g}")
    os.makedirs(work, exist_ok=True)
    log(f"# gpu: {gpu_line(device)}")
    if device != "cpu":
        from genmap_tpu_torch import kernels

        t = time.perf_counter()
        kernels.build()
        log(f"# kernels: built in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    codes_path, fa_path = write_corpus(work, n)
    log(f"# corpus: {n} bp {CHROM} (make_genomelike seed {SEED}) written in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    exe = build_counter(work)
    log(f"# counter: built in {time.perf_counter() - t:.1f} s (g++ -O2 -march=native)")
    counters = start_counters(exe, codes_path, work)
    try:
        idx = os.path.join(work, "idx")
        log(f"# index: built in {build_index(fa_path, idx):.1f} s")
        ok = True
        for K, E in CONFIGS:
            res = map_config(idx, os.path.join(work, f"out_{K}_{E}"), K, E, device)
            counter_s = counters[(K, E)].join()
            cmp = compare(res["bedgraph"], counters[(K, E)].out)
            ok &= cmp["equal"]
            log(config_line(K, E, label, res, counter_s, cmp))
    finally:
        for c in counters.values():
            c.stop()
    print("PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
