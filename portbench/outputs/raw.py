"""`-r`: one little-endian value per position: frequencies as uint8 (`-fs`,
`.freq8`) or uint16 (`-fl`, `.freq16`), else mappability as float32
reciprocals (`.map`)."""

from __future__ import annotations

import numpy as np


def _kind(flags):
    if "-fs" in flags:
        return ".freq8", "<u1"
    if "-fl" in flags:
        return ".freq16", "<u2"
    return ".map", "<f4"


def suffix(flags) -> str:
    return _kind(flags)[0]


def read(path, genome, flags) -> np.ndarray:
    return np.fromfile(path, dtype=_kind(flags)[1])


def expect(freq, flags) -> np.ndarray:
    if "-fs" in flags or "-fl" in flags:
        return np.asarray(freq).astype(_kind(flags)[1])
    f = np.asarray(freq).astype(np.float32)
    return np.where(f != 0, np.float32(1.0) / np.maximum(f, 1), np.float32(0.0))
