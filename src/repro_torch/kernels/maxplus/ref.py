"""Plain PyTorch versions of the max-plus kernel (the tests' oracles)."""

from __future__ import annotations

import torch

NEG_INF = -1e9
# elements of one [M, chunk, N] temporary: 512 MB of f32 at most
_CHUNK_ELEMS = 1 << 27


def maxplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i, j] = max_k (A[i, k] + B[k, j]), with no floor: the reference's
    oracle. Chunked over k, so that memory is O(M N chunk), not O(M N K)."""
    m, k = a.shape
    n = b.shape[1]
    chunk = max(1, min(k, _CHUNK_ELEMS // max(1, m * n)))
    out = None
    for k0 in range(0, k, chunk):
        part = (a[:, k0:k0 + chunk, None] + b[None, k0:k0 + chunk, :]).amax(1)
        out = part if out is None else torch.maximum(out, part)
    return out


def maxplus_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function: ``maxplus_matmul_ref`` floored at NEG_INF, as
    the TPU kernel, whose output tile starts at NEG_INF, computes it."""
    return maxplus_matmul_ref(a, b).clamp_min(NEG_INF)

