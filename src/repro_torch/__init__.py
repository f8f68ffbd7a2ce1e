"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100: LM
serving and training, and the Cascade compiler's default compile
(``repro_torch.core``).

Layout mirrors the JAX package module for module (``repro_torch.models.layers``
is the counterpart of ``repro.models.layers``). The port imports torch, numpy
and the standard library only; its TPU kernels are CUDA kernels written for
``sm_90a`` under ``kernels/*/csrc``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
