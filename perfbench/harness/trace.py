"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
warm steps or calls, read from the profiler's raw events (name, start, end;
building its event tree takes minutes at 10^5-10^6 kernels), as the port's
card checks read them.

From the device's events: busy seconds (the union of kernel intervals),
the span from the first kernel's start to the last one's end, time by
kernel name. From the host's: the kernel and graph launches of the CUDA
runtime, and which host operation was running in each idle gap of the
device.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

# the CUDA runtime and driver calls that start device work
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cudaLaunchCooperativeKernel")
NAME_CHARS = 120                  # names in the breakdown are cut to this


@dataclass
class Trace:
    window_s: float                      # host clock around the stretch
    units: int                           # steps or calls traced
    kernels: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    launches: int
    busy_s: float
    span_s: float
    gaps_by_host_op: List[Tuple[str, float]] = field(default_factory=list)

    def time_by_kernel(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out

    def kernel_seconds(self, pattern: str) -> float:
        """Seconds of the kernels whose name holds ``pattern``."""
        return sum(e - s for n, s, e in self.kernels if pattern in n) / 1e9

    def kernel_calls(self, pattern: str) -> int:
        """Launches of the kernels whose name holds ``pattern``."""
        return sum(1 for n, _, _ in self.kernels if pattern in n)

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.time_by_kernel().items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s]
                              for n, s in self.gaps_by_host_op[:10]]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _gaps_by_host_op(busy: List[Tuple[int, int]],
                     host: List[Tuple[str, int, int]], top: int = 4000
                     ) -> List[Tuple[str, float]]:
    """The device's idle gaps (the ``top`` longest) summed by the innermost
    host operation running at each gap's middle."""
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by: Dict[str, float] = {}
    for length, s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 2000), -1):
            name, hs, he = host[j]
            if he >= mid and (best is None or he - hs < best[2] - best[1]):
                best = host[j]
        name = best[0] if best else "(no host operation)"
        by[name] = by.get(name, 0.0) + length / 1e9
    return sorted(by.items(), key=lambda x: -x[1])


def profile(unit: Callable[[], None], units: int) -> Trace:
    """Trace ``units`` calls of ``unit`` (already warm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event():
            continue
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_ns(), e.end_ns()))
    launches = sum(1 for n, _, _ in host if n in LAUNCHES)
    busy = _union([(s, e) for _, s, e in kernels])
    busy_s = sum(e - s for s, e in busy) / 1e9
    span_s = (busy[-1][1] - busy[0][0]) / 1e9 if busy else 0.0
    return Trace(window, units, kernels, launches, busy_s, span_s,
                 _gaps_by_host_op(busy, [h for h in host
                                         if h[0] not in LAUNCHES]))
