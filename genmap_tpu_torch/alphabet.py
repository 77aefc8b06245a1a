"""DNA/RNA alphabet encoding.

Codes: A=0, C=1, G=2, T/U=3, N=4.  Anything that is not ACGTUacgtu maps to N
(the reference converts unknown characters to N on FASTA input,
GenMap src/indexing.hpp:13-20).  The sentinel separating sequences is
*not* part of this alphabet; index construction appends it separately.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
ALPHA4 = 4  # Dna4 alphabet size
ALPHA5 = 5  # Dna5 alphabet size

_ENCODE_LUT = np.full(256, N, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
    _ENCODE_LUT[ord(_ch)] = _code
    _ENCODE_LUT[ord(_ch.lower())] = _code


# complement: A<->T, C<->G, N->N
_COMP_LUT = np.array([T, G, C, A, N], dtype=np.uint8)


def encode_seq(seq: bytes | str) -> np.ndarray:
    """Encode an ASCII nucleotide sequence to uint8 codes 0..4."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N maps to N)."""
    return _COMP_LUT[codes][::-1].copy()

