"""(K, e)-frequency of chosen positions, by brute force in plain PyTorch.

GenMap's semantics (`genmap map`, as its randomized test oracle
tests/tests.cpp:30-131 counts them): the frequency of position p is the
number of windows of length K, lying wholly inside one sequence, within
Hamming distance e of the K-mer at p, plus (with reverse complements) the
number within distance e of that K-mer's reverse complement; saturated at
`cap`.  A K-mer that crosses the end of its sequence has frequency 0.  An N
(code 4) matches nothing, not even N.

Every query is compared with every window: one-hot codes (N is the zero
vector) make the count of equal characters a matrix product, computed in
blocks of windows.  The counts are whole numbers of at most K, which float16
and float32 hold exactly, so the result is exact on the card and on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _one_hot(codes: torch.Tensor, dtype) -> torch.Tensor:
    """[..., 4] one-hot of codes 0..3; code 4 (N) is all zeros."""
    eye = torch.cat([torch.eye(4, dtype=dtype, device=codes.device),
                     torch.zeros(1, 4, dtype=dtype, device=codes.device)])
    return eye[codes.long()]


def window_fits(cum: np.ndarray, K: int) -> np.ndarray:
    """bool per position of the concatenation: its K-mer lies inside its
    sequence."""
    total = int(cum[-1])
    ok = np.zeros(total, dtype=bool)
    for lo, hi in zip(cum[:-1], cum[1:]):
        if hi - lo >= K:
            ok[lo:hi - K + 1] = True
    return ok


def frequencies(codes: np.ndarray, cum: np.ndarray, positions: np.ndarray,
                K: int, errors: int, cap: int, rev_compl: bool = True,
                device: str = "cpu", block: int | None = None) -> np.ndarray:
    """uint32 frequency of each of `positions` (global offsets into the
    concatenation `codes`, whose sequences end at `cum[1:]`)."""
    dev = torch.device(device)
    dtype = torch.float16 if dev.type == "cuda" else torch.float32
    positions = np.asarray(positions, dtype=np.int64)
    fits = window_fits(cum, K)
    out = np.zeros(len(positions), dtype=np.uint32)
    ask = positions[fits[positions]]
    n_win = len(codes) - K + 1
    if len(ask) == 0 or n_win <= 0:
        return out
    text = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    pos = torch.from_numpy(ask).to(dev)
    q = text[pos[:, None] + torch.arange(K, device=dev)]  # [S, K]
    queries = [q]
    if rev_compl:
        rc = torch.where(q < 4, 3 - q, q).flip(1)
        queries.append(rc)
    Q = torch.cat(queries).to(torch.int64)
    Qh = _one_hot(Q, dtype).reshape(Q.shape[0], 4 * K)
    G = _one_hot(text, dtype).reshape(-1)  # [4 L]
    valid = torch.from_numpy(fits[:n_win]).to(dev)
    need = K - errors
    hits = torch.zeros(Q.shape[0], dtype=torch.int64, device=dev)
    if block is None:  # about 4 GiB of products per block on the card
        budget = (1 << 32) if dev.type == "cuda" else (1 << 28)
        block = max(1024, budget // (Q.shape[0] * (2 if dtype == torch.float16 else 4)))
    for w0 in range(0, n_win, block):
        n = min(block, n_win - w0)
        W = G[4 * w0:4 * (w0 + n + K - 1)].as_strided((n, 4 * K), (4, 1)).contiguous()
        match = Qh @ W.T  # [2S, n] equal characters
        hits += ((match >= need) & valid[w0:w0 + n]).sum(dim=1)
    hits = hits.cpu().numpy()
    S = len(ask)
    total = hits[:S] + (hits[S:] if rev_compl else 0)
    out[fits[positions]] = np.minimum(total, cap).astype(np.uint32)
    return out
