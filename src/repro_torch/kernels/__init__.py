"""Kernels of the port: CUDA C++ for ``sm_90a`` beside a plain PyTorch version.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; it counts its kernel launches in a ``launches`` attribute.
"""

from torch.distributed.tensor import DTensor


def refuse_dtensors(name: str, *xs) -> None:
    """Raise on a DTensor among ``xs``: a kernel takes one device's tensors
    (a DTensor's ``data_ptr()`` is 0). The model runs a kernel on each
    rank's shards through ``local_map`` (``models/layers.py``)."""
    if any(isinstance(x, DTensor) for x in xs):
        raise TypeError(f"{name} takes plain tensors, not DTensors: run it "
                        f"on each rank's shards through local_map")
