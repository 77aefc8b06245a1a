"""The system under test, as the benchmark drives it: the `index` and `map`
commands of `genmap_tpu_torch`, its kernel library and launch counters.

This is the one module of the benchmark that imports the port.  The host spans
(around FMIndexData.load, MappabilityEngine.__init__ and compute_file, and
the CLI's writers) and the capture of kernel arguments
wrap the port's functions from here, without editing a file of the port.
"""

from __future__ import annotations

import contextlib
import inspect
import re
import time

import torch

from genmap_tpu_torch import kernels
from genmap_tpu_torch.cli import map_cmd
from genmap_tpu_torch.cli.main import main as cli_main
from genmap_tpu_torch.engine.mappability import MappabilityEngine
from genmap_tpu_torch.index.fmindex import FMIndexData

# the writers that map_cmd calls (bound in its namespace at import)
WRITERS = ("save_raw", "save_txt", "save_wig", "save_bedgraph", "save_csv")
SPANS = ("FMIndexData.load", "MappabilityEngine.__init__",
         "MappabilityEngine.compute_file") + WRITERS


def build_index(fasta: str, index_dir: str, sampling: int) -> float:
    """`genmap-tpu-torch index -F fasta -I index_dir -S sampling`; seconds."""
    t = time.perf_counter()
    rc = cli_main(["index", "-F", fasta, "-I", index_dir, "-S", str(sampling)])
    if rc != 0:
        raise RuntimeError(f"index exited {rc}")
    return time.perf_counter() - t


def load_kernels() -> int:
    """Load every kernel library of the port (nvcc builds the ones that its
    build directory, inside the checkout, does not hold yet); returns how
    many were built."""
    return len(kernels.build())


def map_job(argv: list[str], device: str) -> dict:
    """One `genmap-tpu-torch map` job; its exit code, report and launches."""
    kernels.reset_launches()
    report: dict = {}
    rc = map_cmd.map_main([*argv, "--device", device], report=report)
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(rc=rc, report=report, launches=kernels.launch_counts())


@contextlib.contextmanager
def host_spans(spans):
    """Host spans (trace.Spans) around the port's layers, named as in
    SPANS."""
    saved = [
        (FMIndexData, "load", staticmethod(FMIndexData.load)),
        (MappabilityEngine, "__init__", MappabilityEngine.__init__),
        (MappabilityEngine, "compute_file", MappabilityEngine.compute_file),
    ] + [(map_cmd, w, getattr(map_cmd, w)) for w in WRITERS]
    FMIndexData.load = staticmethod(spans.wrap(FMIndexData.load, SPANS[0]))
    MappabilityEngine.__init__ = spans.wrap(MappabilityEngine.__init__, SPANS[1])
    MappabilityEngine.compute_file = spans.wrap(MappabilityEngine.compute_file, SPANS[2])
    for w in WRITERS:
        setattr(map_cmd, w, spans.wrap(getattr(map_cmd, w), w))
    try:
        yield
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)


@contextlib.contextmanager
def kernel_calls(on_call, names):
    """Route every call of the kernel wrappers `names` through
    on_call(name, bound arguments, result) after the call."""
    saved = {}
    for n in names:
        orig = getattr(kernels, n)
        sig = inspect.signature(orig)

        def wrapper(*a, _n=n, _orig=orig, _sig=sig, **kw):
            res = _orig(*a, **kw)
            bound = _sig.bind(*a, **kw)
            bound.apply_defaults()
            on_call(_n, bound.arguments, res)
            return res

        saved[n] = orig
        setattr(kernels, n, wrapper)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)


def kernel_symbols() -> dict[str, str]:
    """Each `__global__` function of the port's CUDA sources -> its kernel."""
    out = {}
    for name, k in kernels.KERNELS.items():
        with open(k.source_path) as f:
            for sym in re.findall(
                    r"__global__\s+void\s+(?:\w+(?:\([^)]*\))?\s+)?(\w+)\s*\(", f.read()):
                out[sym] = name
    return out
