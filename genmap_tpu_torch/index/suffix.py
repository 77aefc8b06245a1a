"""Suffix array construction (host side).

The reference delegates to a vendored libdivsufsort
(GenMap src/seqan_libdivsufsort.h:96).  We use our own backends:

  - a native C++ SA-IS library (genmap_tpu_torch.native) for large inputs
  - a numpy prefix-doubling fallback (O(n log^2 n)) that has no native
    dependency and is fast enough for tests and mid-size genomes

Both produce the standard suffix array of the byte string, which is identical
to what any correct SACA produces (suffix order over a text whose per-sequence
sentinels are equal bytes is still well-defined: no suffix is a prefix of
another once the final sentinel terminates the text).
"""

from __future__ import annotations

import os
import sys

import numpy as np


def suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array over a small-alphabet uint8 text."""
    n = int(len(text))
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    rank = text.astype(np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        idx = np.lexsort((key2, rank))
        changed = (rank[idx[1:]] != rank[idx[:-1]]) | (key2[idx[1:]] != key2[idx[:-1]])
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[idx] = np.concatenate(([0], np.cumsum(changed)))
        rank = new_rank
        if rank[idx[-1]] == n - 1:
            return idx.astype(np.int64)
        k *= 2


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array with the best available backend.

    The native SA-IS backend is required above a small size cutoff: the numpy
    fallback is O(n log^2 n) and silently absorbing a native build failure at
    genome scale turns a seconds-long build into hours.  Below the cutoff
    the fallback is fine for tests on machines without a compiler, but it
    still warns.
    """
    try:
        from genmap_tpu_torch.native import sais

        return sais.suffix_array(text)
    except Exception as e:
        if len(text) > 2_000_000 and not os.environ.get("GENMAP_TPU_ALLOW_SLOW_SACA"):
            raise RuntimeError(
                "native SA-IS backend unavailable and input is too large for "
                "the numpy fallback (set GENMAP_TPU_ALLOW_SLOW_SACA=1 to force)"
            ) from e
        print(
            f"WARNING: native SA-IS backend unavailable ({e!r}); "
            "falling back to the slow numpy suffix-array builder",
            file=sys.stderr,
        )
        return suffix_array_numpy(text)
