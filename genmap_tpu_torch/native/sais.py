"""ctypes loader for the native SA-IS library (compiled on first use)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_LIB = None


def _candidate_dirs() -> list[str]:
    """Writable places for the compiled .so, in preference order: the
    package's own build directory (listed in .gitignore), then the temp
    directory."""
    here = os.path.dirname(os.path.dirname(__file__))
    return [
        os.path.join(here, "_build"),
        os.path.join(tempfile.gettempdir(), "genmap_tpu_torch"),
    ]


def _build_lib() -> str:
    # explicit override (e.g. CI builds the library with sanitizers)
    override = os.environ.get("GENMAP_SAIS_LIB")
    if override:
        if not os.path.exists(override):
            raise RuntimeError(f"GENMAP_SAIS_LIB={override} does not exist")
        return override
    src = os.path.join(os.path.dirname(__file__), "sais.cpp")
    errors = []
    for cache in _candidate_dirs():
        try:
            os.makedirs(cache, exist_ok=True)
            out = os.path.join(cache, "libgenmap_sais.so")
            if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
                return out
            with tempfile.TemporaryDirectory(dir=cache) as td:
                tmp = os.path.join(td, "libgenmap_sais.so")
                for flags in (["-O3", "-march=native"], ["-O3"]):
                    try:
                        subprocess.run(
                            ["g++", *flags, "-funroll-loops", "-fPIC", "-shared",
                             "-o", tmp, src],
                            check=True,
                            capture_output=True,
                        )
                        break
                    except subprocess.CalledProcessError as e:
                        last = e
                else:
                    raise RuntimeError(
                        f"g++ failed: {last.stderr.decode(errors='replace')[-2000:]}"
                    )
                os.replace(tmp, out)
            return out
        except Exception as e:  # try the next candidate dir
            errors.append(f"{cache}: {e}")
    raise RuntimeError("could not build libgenmap_sais.so:\n" + "\n".join(errors))


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build_lib())
        lib.genmap_sais_u8_u32.restype = ctypes.c_int
        lib.genmap_sais_u8_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint64,
            ctypes.c_uint32,
        ]
        lib.genmap_sais_u8_i64.restype = ctypes.c_int
        lib.genmap_sais_u8_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        _LIB = lib
    return _LIB


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a uint8 text (arbitrary bytes, repeated values fine).

    Internally shifts the alphabet up by one and appends a unique smallest
    terminal (this preserves plain lexicographic suffix order), runs SA-IS,
    and drops the terminal's entry.  Index width (uint32 / int64) is chosen
    from the input size; the uint32 path covers inputs up to 2^32 - 2.
    """
    n = len(text)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    t = np.empty(n + 1, dtype=np.uint8)
    np.add(text, 1, out=t[:n], casting="unsafe")
    t[n] = 0
    k = int(t[:n].max())
    lib = _lib()
    if n + 1 < 2**32 - 1:
        sa = np.empty(n + 1, dtype=np.uint32)
        rc = lib.genmap_sais_u8_u32(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n + 1,
            k,
        )
    else:
        sa = np.empty(n + 1, dtype=np.int64)
        rc = lib.genmap_sais_u8_i64(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n + 1,
            k,
        )
    if rc != 0:
        raise RuntimeError("sais failed")
    assert sa[0] == n
    return sa[1:]  # uint32 or int64 depending on input size
