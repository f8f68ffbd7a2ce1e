"""Device selection for the port's entry points.

Entry points run on the card. The CPU is used only when the caller asks for
it (the tests do); a missing card is an error, never a quiet fallback.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``"cuda"`` by default; raises without CUDA unless the CPU was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device, so
    a kernel wrapper can size its grid without a runtime call per launch)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
