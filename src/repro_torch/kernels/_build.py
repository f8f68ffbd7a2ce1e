"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel directory ``kernels/<name>/csrc/`` becomes one shared library with
a plain C interface, ``build/kernels/lib<name>-<hash>.so`` at the root of the
checkout. The hash covers the sources and the flags, so an edit rebuilds.
``nvcc`` comes from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or the
``PATH``; nothing is downloaded. The build happens at the first CUDA call of a
kernel, or up front through ``build_all``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted({p.parent.parent.name
                   for p in KERNELS_DIR.glob("*/csrc/*.cu")})


def _sources(name: str) -> List[Path]:
    csrc = KERNELS_DIR / name / "csrc"
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every kernel library not built yet: one nvcc per kernel, all
    started together. Returns ``{name: library path}``; raises if any build
    fails. nvcc's output (ptxas register and shared-memory use) is kept
    beside each library as ``<library>.log``."""
    names = kernel_names() if names is None else list(names)
    jobs = {}
    try:
        for name in names:
            path = lib_path(name)
            if path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in _sources(name) if s.suffix == ".cu"]]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, path)
        errors = []
        for name, (proc, tmp, path) in jobs.items():
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            path.with_name(path.name + ".log").write_text(out)
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, path)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib
