"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into its own shared library for ``sm_90a``, then loaded
with ``ctypes``. Libraries are named by a hash of their source and land in
``_build/`` beside the package (listed in ``.gitignore``), so an edited source
rebuilds and an unchanged one is reused. Nothing is built at import: the
first launch builds (or :func:`build` does, ahead of traffic).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: the compiler's report (registers, shared memory, spills) of the last build
#: of each kernel in this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled on first use and need the CUDA"
            " toolkit (set CUDA_HOME)"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (source-hashed)."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path) -> Tuple[str, ...]:
    return (_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu"))


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` each,
    all started together. Raises ``RuntimeError`` with the compiler's output
    when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    jobs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        jobs[name] = (
            tmp,
            subprocess.Popen(
                nvcc_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    failed = []
    for name, (tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])  # atomic: a concurrent reader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def current_stream(device: int) -> int:
    """The raw ``cudaStream_t`` handle of ``device``'s current stream, which
    every wrapper hands its kernel's entry point.

    Read with ``torch._C._cuda_getCurrentRawStream``, which builds no
    ``torch.cuda.Stream`` object: host time a launch counts where a kernel
    runs once a stat-scores update. That call is private to torch (checked on
    torch 2.11, CUDA 12.8); a torch without it gets the same handle from the
    public ``torch.cuda.current_stream(device).cuda_stream``."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device)
    return torch.cuda.current_stream(device).cuda_stream
