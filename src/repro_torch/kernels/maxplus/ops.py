"""Longest path over a timing matrix through the max-plus kernel.

``longest_path`` takes the dense max-plus adjacency built by
``repro_torch.core.sta.timing_matrix`` and returns each vertex's worst-case
arrival time; the relaxation runs as repeated squarings, so it stays on the
device.
"""

from __future__ import annotations

import math

import torch

from .maxplus import NEG_INF, maxplus_matmul


def longest_path(m: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Worst-case arrival time of every vertex from ``src``.

    m[i, j] = delay of edge j -> i, NEG_INF when absent. Doubling:
    (I (+) M)^(2^s) collapses 2^s relaxation steps, so the closure takes
    ``max(1, ceil(log2 n))`` squarings through the kernel instead of
    diameter matrix-vector steps. In a timing matrix inputs launch from
    the ``"SRC"`` vertex, so pass ``src=verts.index("SRC")``.
    """
    n = m.shape[0]
    if m.dim() != 2 or m.shape[1] != n:
        raise ValueError(f"m must be square, got {tuple(m.shape)}")
    # I (+) M in the semiring: I has 0 on the diagonal, NEG_INF off it
    eye = torch.full((n, n), NEG_INF, dtype=m.dtype, device=m.device)
    eye.fill_diagonal_(0.0)
    closure = torch.maximum(m, eye)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        closure = maxplus_matmul(closure, closure)
    arr = torch.full((n,), NEG_INF, dtype=m.dtype, device=m.device)
    arr[src] = 0.0
    return (closure + arr[None, :]).amax(1)
