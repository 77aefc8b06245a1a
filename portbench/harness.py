"""One run of one cell of BENCHMARK.json: set-up, the measured window, the
traced reading (`--trace 1`), the check against the reference, the result.

Set-up (timed whole as `setup_s`, from the harness's first statement):
the genome made from the configuration and the run's seed (genome.py),
written as FASTA under the run's TMPDIR; the index built by the port's
`index` command; the port's kernel libraries loaded (built only by a
checkout's first run); one warm `map` job with the cell's flags.  The window
then runs `map` jobs back to back (window.py), each with a fresh output
directory, and every job pays what a user's job pays: index load, engine
construction, calibration, compute and the writers.  Afterwards the files
every job wrote are judged at positions drawn from the run's seed against
the plain reference (reference/), and every position against what the
genome alone fixes (a k-mer that crosses a sequence's end, or holds an N,
reads 0; every other reads 1 or more).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from portbench import trace as tracing
from portbench.genome import make_genome, seed_sequence, write_fasta
from portbench.reference.frequency import frequencies, window_fits
from portbench.window import run_window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "genmap_tpu")
# output flags of `map` -> the reader module in outputs/
FORMAT_FLAGS = {"-r": "raw", "-t": "txt", "-w": "wig", "-bg": "bedgraph",
                "-b": "bed", "-d": "csv"}
FASTA_BASE = "genome"


class Spec:
    """A cell as BENCHMARK.json and its files define it."""

    def __init__(self, bench: dict, workload: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.bench = bench
        self.cell = cells[workload]
        cfg = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        with open(os.path.join(root, cfg["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, "traffic", self.cell["traffic"] + ".json")) as f:
            self.traffic = json.load(f)

    @classmethod
    def of(cls, bench: dict, cell: dict, config: dict, traffic: dict) -> "Spec":
        """A cell from objects in memory (tests)."""
        spec = cls.__new__(cls)
        spec.bench, spec.cell, spec.config, spec.traffic = bench, cell, config, traffic
        return spec

    @classmethod
    def load(cls, workload: str, root: str = ROOT) -> "Spec":
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            return cls(json.load(f), workload, root)

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics of a run: end-to-end ones, or with trace per-layer."""
        return self.bench["per_layer" if trace else "end_to_end"]


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, found by name."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def output_readers(flags) -> dict:
    """The reader module of each output kind that the flags ask for."""
    kinds = [FORMAT_FLAGS[f] for f in flags if f in FORMAT_FLAGS]
    if not kinds:
        raise ValueError("the traffic asks for no output")
    return {k: load_module("outputs", k) for k in kinds}


def selected(genome, selection, K: int) -> np.ndarray:
    """bool per position: a k-mer start that the job maps (all, or those in
    the selection's [chrom, begin, end) intervals)."""
    fits = window_fits(genome.cum, K)
    if selection is None:
        return fits
    index = {n: i for i, n in enumerate(genome.names)}
    mask = np.zeros(genome.length, dtype=bool)
    for chrom, begin, end in selection:
        lo = genome.cum[index[chrom]]
        mask[lo + begin:lo + end] = True
    return mask & fits


def sample_positions(genome, K: int, n: int, seed: int, mask: np.ndarray) -> np.ndarray:
    """`n` positions drawn from the seed among the mapped ones, and around
    every sequence's ends the first 2 and the last K + 1 positions."""
    rng = np.random.default_rng(seed_sequence(seed, 1))
    cand = np.flatnonzero(mask)
    pick = rng.choice(cand, size=min(n, len(cand)), replace=False) if len(cand) else cand
    ends = [np.arange(max(lo, hi - K - 1), hi) for lo, hi in zip(genome.cum[:-1], genome.cum[1:])]
    starts = [np.arange(lo, min(lo + 2, hi)) for lo, hi in zip(genome.cum[:-1], genome.cum[1:])]
    return np.unique(np.concatenate([pick, *ends, *starts])).astype(np.int64)


def judge(jobs, genome, traffic, readers, positions, ref, mask) -> dict:
    """The numbers compared, each with its limit: values that differ from
    the reference at the sampled positions, positions that break what the
    genome alone fixes, and outputs that are missing or malformed, summed
    over the window's jobs that returned 0."""
    K, flags = traffic["K"], traffic["flags"]
    fits = window_fits(genome.cum, K)
    has_n = np.zeros(genome.length, dtype=bool)
    nwin = np.convolve((genome.codes == 4).astype(np.int64), np.ones(K, np.int64))[K - 1:]
    has_n[:len(nwin)] = nwin > 0
    zero = ~fits | has_n
    if traffic.get("selection") is not None:
        zero = zero | ~mask
    judged = positions if traffic.get("selection") is None else positions[mask[positions]]
    ref_at = ref if traffic.get("selection") is None else ref[mask[positions]]
    wrong = broken = unreadable = 0
    for job in jobs:
        if not job["ok"]:
            continue
        for kind, mod in readers.items():
            path = os.path.join(job["out"], FASTA_BASE + ".genmap" + mod.suffix(flags))
            try:
                vals = mod.read(path, genome, flags)
            except (OSError, ValueError, KeyError) as e:
                print(f"portbench: unreadable {kind} output of job {job['i']}: {e}",
                      file=sys.stderr)
                unreadable += 1
                continue
            if len(vals) != genome.length:
                unreadable += 1
                continue
            wrong += int((vals[judged] != mod.expect(ref_at, flags)).sum())
            z = mod.expect(np.zeros(1, np.uint32), flags)[0]
            region = slice(None) if traffic.get("selection") is None else mask
            broken += int(((vals == z) != zero)[region].sum())
    return {"wrong_values": {"value": wrong, "limit": 0},
            "broken_positions": {"value": broken, "limit": 0},
            "unreadable_outputs": {"value": unreadable, "limit": 0}}


def _cuda_ready(chips: int) -> str | None:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}"
    return None


def host_facts() -> list[str]:
    """The machine's facts for the run's earlier lines."""
    import torch

    lines = [f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"python {platform.python_version()}, {torch.cuda.device_count()} CUDA devices"]
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        lines.append(f"nvidia-smi: {out}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi: not read ({e})")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        lines.append(f"nvcc: {out[-1] if out else 'no output'}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvcc: not read ({e})")
    cpu = platform.machine()
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        cpu = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                    if ln.startswith("Model name")), cpu)
    threads = "?"
    with contextlib.suppress(OSError):
        threads = len(os.listdir("/proc/self/task"))
    lines.append(f"host: {cpu}, {os.cpu_count()} CPUs, load average "
                 + " ".join(f"{x:.2f}" for x in os.getloadavg())
                 + f", {threads} threads in this process, torch intra-op threads "
                 f"{torch.get_num_threads()}")
    return lines


def host_sample() -> dict:
    """The process's CPU seconds (user and system, all its threads)."""
    t = os.times()
    return {"cpu_s": t.user + t.system}


def host_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, log=print) -> dict:
    """One run of the cell; returns the record, the checks and the result
    line's parts.  `device` "cpu" runs the port's plain versions (tests)."""
    import torch

    from portbench import program, work as workmod

    cfg, trf = spec.config, spec.traffic
    K, E, flags = int(trf["K"]), int(trf["E"]), list(trf["flags"])
    cuda = device == "cuda"
    readers = output_readers(flags)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        t = time.perf_counter()
        genome = make_genome(cfg, seed)
        fasta = os.path.join(tmp, FASTA_BASE + ".fa")
        write_fasta(fasta, genome)
        genome_s = time.perf_counter() - t
        index = os.path.join(tmp, "index")
        index_s = program.build_index(fasta, index, int(cfg["sampling"]))
        t = time.perf_counter()
        built = program.load_kernels() if cuda else 0
        kernel_s = time.perf_counter() - t
        extra = []
        if trf.get("selection") is not None:
            bed = os.path.join(tmp, "selection.bed")
            with open(bed, "w") as f:
                for chrom, begin, end in trf["selection"]:
                    f.write(f"{chrom}\t{begin}\t{end}\n")
            extra = ["-S", bed]

        def job(i, name=None):
            out = os.path.join(tmp, name or f"job{i}")
            os.makedirs(out)
            argv = ["-I", index, "-O", out + "/", "-K", str(K), "-E", str(E),
                    *flags, *extra]
            h0 = host_sample()
            with spans.span(tracing.JOB_SPAN):
                res = program.map_job(argv, device)
            return dict(res, ok=res["rc"] == 0, i=i, out=out, host=host_delta(h0, host_sample()),
                        n_kmers=res["report"].get("n_kmers", 0))

        spans = tracing.Spans()
        t = time.perf_counter()
        warm = job(-1, "warm")
        warm_s = time.perf_counter() - t
        if not warm["ok"]:
            raise RuntimeError(f"the warm job exited {warm['rc']}")
        shutil.rmtree(warm["out"])
        setup_s = time.perf_counter() - t_start
        setup_peak = 0
        if cuda:
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        prof = None
        spans.spans.clear()
        with contextlib.ExitStack() as stack:
            if trace:
                prof = stack.enter_context(tracing.Profiled(cuda))
                stack.enter_context(program.host_spans(spans))
                stack.enter_context(spans.span(tracing.WINDOW_SPAN))
            opened = time.time()
            window = run_window(job, seconds)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        log(f"portbench: window opened at {opened:.3f} (epoch s), "
            f"{window['window_s']:.3f} s, {len(window['jobs'])} jobs, "
            f"{genome.kmers(K)} k-mers per whole-genome job; job walls "
            + " ".join(f"{j['wall_s']:.3f}" for j in window["jobs"]))
        for j in window["jobs"]:
            if not j["ok"]:
                log(f"portbench: job {j.get('i')} failed: rc {j.get('rc')} "
                    f"{j.get('error', '')}")

        record = dict(
            setup=dict(setup_s=setup_s, genome_s=genome_s, index_build_s=index_s,
                       kernel_load_s=kernel_s, kernels_built=built, warm_job_s=warm_s),
            window=window, memory=dict(window_peak_bytes=window_peak,
                                       setup_peak_bytes=setup_peak),
            trace=None, work=None)
        if trace:
            t = time.perf_counter()
            w = next(sp for sp in spans.spans if sp[2] == tracing.WINDOW_SPAN)
            record["trace"] = tracing.read_events(prof.events(), program.kernel_symbols(),
                                                  spans.spans, w[:2])
            del prof
            log(f"portbench: trace read in {time.perf_counter() - t:.1f} s, "
                f"{record['trace']['device_events']} device events")
            record["work"] = counted_job(job, workmod, device)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t = time.perf_counter()
        mask = selected(genome, trf.get("selection"), K)
        positions = sample_positions(genome, K, int(trf["check_positions"]), seed, mask)
        cap = 255 if "-fs" in flags else 65535
        ref = frequencies(genome.codes, genome.cum, positions, K, E, cap,
                          rev_compl="-nc" not in flags, device=device)
        checks = judge(window["jobs"], genome, trf, readers, positions, ref, mask)
        log(f"portbench: checked {len(positions)} positions of every job against the "
            f"reference and every position against the genome in "
            f"{time.perf_counter() - t:.1f} s")
        return dict(record=record, checks=checks,
                    memory_peak_bytes=max(setup_peak, window_peak))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# calls of a kernel whose work the counted job reads: all of its first
# COUNT_ALL, then every COUNT_EVERY-th, standing for the calls up to the next
COUNT_ALL, COUNT_EVERY = 64, 8


def sampled_total(first: float, later: list[tuple[int, float]], calls: int) -> float:
    """A kernel's bound over all its `calls`: the sum over its first
    COUNT_ALL calls, and each later counted call j times the calls from j
    up to the next counted one."""
    return first + sum(b * min(COUNT_EVERY, calls - j) for j, b in later)


def counted_job(job, workmod, device: str) -> dict | None:
    """One more job after the window, each kernel's bound summed from its
    calls' arguments (work.py; a kernel's later calls sampled, as
    COUNT_ALL and COUNT_EVERY say); None without published peaks."""
    import torch

    from portbench import program

    kind = torch.cuda.get_device_name(0) if device == "cuda" else None
    pk = workmod.peaks(kind) if kind else None
    if pk is None:
        return None
    first: dict[str, float] = {}
    later: dict[str, list] = {}
    calls: dict[str, int] = {}

    def on_call(name, args, result):
        j = calls.get(name, 0)
        calls[name] = j + 1
        if j >= COUNT_ALL and (j - COUNT_ALL) % COUNT_EVERY:
            return
        nbytes, nops = workmod.kernel_work(name, args, result)
        b = max(nbytes / pk["bytes_per_s"], nops / pk["ops_per_s"])
        if j < COUNT_ALL:
            first[name] = first.get(name, 0.0) + b
        else:
            later.setdefault(name, []).append((j, b))

    t = time.perf_counter()
    with program.kernel_calls(on_call, workmod.COUNTED):
        res = job(-2, "counted")
    if not res["ok"]:
        raise RuntimeError(f"the counted job exited {res['rc']}")
    print(f"portbench: counted job in {time.perf_counter() - t:.1f} s", flush=True)
    bound = {k: sampled_total(first.get(k, 0.0), later.get(k, []), n) for k, n in calls.items()}
    return dict(bound_s=bound, launches=res["launches"])


def result_line(spec: Spec, out: dict, trace: bool, device: str, chips: int) -> dict:
    import torch

    record, checks = out["record"], out["checks"]
    jobs = record["window"]["jobs"]
    failed = sum(1 for j in jobs if not j["ok"])
    metrics = {}
    for m in spec.metrics(trace):
        v = load_module("metrics", m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else platform.processor(),
           "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": len(jobs), "failed": failed,
            "metrics": metrics, "device": dev}
    if trace and record["trace"]:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        line["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                             "idle_gaps": record["trace"]["idle_gaps"]}
    line["checks"] = checks
    return line


def log_details(out: dict, log) -> None:
    """Earlier lines: set-up's parts, each job, per-kernel rooflines."""
    rec = out["record"]
    log("portbench: setup " + " ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in rec["setup"].items()))
    for j in rec["window"]["jobs"]:
        if j["ok"]:
            st = j["report"]["stats"]
            h = " ".join(f"{k} {v:.3f} s" for k, v in j["host"].items())
            log(f"portbench: job {j['i']}: wall {j['wall_s']:.3f} s, compute "
                f"{j['report']['compute_s']:.3f} s, dispatch {st['dispatch_s']:.3f} s, {h}, "
                f"batches {st['batches']} + {sum(st.get('rung_batches', {}).values())}, "
                f"launches {sum(j['launches'].values())}, k-mers {j['n_kmers']}")
    tr, wk = rec.get("trace"), rec.get("work")
    if tr and wk:
        n_jobs = {}
        for j in rec["window"]["jobs"]:
            for k, n in j["launches"].items():
                n_jobs[k] = n_jobs.get(k, 0) + n
        for k, dev_s in sorted(tr["kernel_s"].items(), key=lambda kv: -kv[1]):
            c = wk["launches"].get(k, 0)
            if k in wk["bound_s"] and c and dev_s > 0:
                b = wk["bound_s"][k] * n_jobs.get(k, 0) / c
                log(f"portbench: roofline {k}: bound {b * 1e3:.3f} ms over device "
                    f"{dev_s * 1e3:.3f} ms = {100 * b / dev_s:.2f} %")
            else:
                log(f"portbench: roofline {k}: device {dev_s * 1e3:.3f} ms, no count")


def main(argv: list[str], t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = Spec.load(args.workload)
    chips = int(spec.cell["chips"])
    why = _cuda_ready(chips)
    if why:
        print(f"portbench: no result: {why}", file=sys.stderr)
        return 2
    if chips != 1:
        print("portbench: no result: only one-chip cells are supported", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    log_details(out, print)
    for line in host_facts():
        print(f"portbench: {line}")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: no result: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(spec, out, bool(args.trace), "cuda", chips)
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
