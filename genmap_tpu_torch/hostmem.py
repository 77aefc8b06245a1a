"""Host-memory tuning for hosts with slow transparent-huge-page faults.

numpy calls madvise(MADV_HUGEPAGE) on every large allocation; on hosts where
a 2 MB huge-page fault is slow, writing a fresh large numpy array crawls
while a plain mmap of the same size fills at memory speed.  Every fresh
numpy temporary of the index-construction pipeline pays that cost.

Fixes applied here (idempotent):
  * turn numpy's huge-page madvise off at runtime (and via the env var for
    child processes)
  * raise glibc's mmap/trim thresholds so freed large buffers are reused from
    the heap instead of being returned to the kernel and re-faulted

Call once before heavy host-side numpy work (CLI entry, build).
"""

from __future__ import annotations

import ctypes
import os

_DONE = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def retain_heap() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:
        import numpy as np

        # runtime switch for the already-imported numpy (the env var is only
        # read at import time)
        np._core.multiarray._set_madvise_hugepage(False)
    except Exception:
        pass
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(_M_MMAP_THRESHOLD, 64 << 20)
        libc.mallopt(_M_TRIM_THRESHOLD, 64 << 20)
    except Exception:
        pass  # non-glibc platform: defaults are fine
