"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into its own shared library for ``sm_90a``, then loaded
with ``ctypes``. Libraries land in ``_build/`` beside the package (listed in
``.gitignore``) under a name hashed on their source, the shared headers
``csrc/*.cuh`` and the toolchain (``nvcc --version``, :data:`NVCC_FLAGS`
and the target), so an edited source or another toolkit rebuilds and an
unchanged build is reused. Each build leaves a sidecar beside its library,
and a library is loaded only when its sidecar vouches for it
(``native/libstore.py``): a damaged one is warned about, deleted and
rebuilt, and one that still does not build or load raises. Nothing is built
at import: the first launch builds (or :func:`build` does, ahead of
traffic).

The lean launch path (``csrc/launch.cuh``; the ``binned_curve`` and
``retrieval_topk_stats`` wrappers): the C entry takes the device index and
switches device only when the caller's current one differs, restoring it
before it returns, so the wrapper enters no ``torch.cuda.device`` context;
the runtime queries a launch needs are cached in C once a device; and device
memory a kernel keeps from call to call comes from :class:`StreamScratch`,
one buffer per stream, so no call allocates scratch.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from torchmetrics_tpu_torch.native import libstore

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
TARGET = "sm_90a"

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: the compiler's report (registers, shared memory, spills) of the last build
#: of each kernel in this process
build_logs: Dict[str, str] = {}


def _nvcc_path() -> Optional[str]:
    from torch.utils.cpp_extension import CUDA_HOME

    return None if CUDA_HOME is None else str(Path(CUDA_HOME) / "bin" / "nvcc")


def _nvcc() -> str:
    path = _nvcc_path()
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled on first use and need the CUDA"
            " toolkit (set CUDA_HOME)"
        )
    return path


def toolchain() -> str:
    """What a kernel library's bytes depend on besides its sources: the
    ``nvcc --version`` output, :data:`NVCC_FLAGS` and :data:`TARGET`."""
    return libstore.toolchain(_nvcc_path() or "nvcc", NVCC_FLAGS, TARGET)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (hashed on its
    source, the shared headers and :func:`toolchain`)."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    return BUILD_DIR / libstore.library_name(f"lib{name}", sources, toolchain())


def nvcc_command(name: str, out: Path) -> Tuple[str, ...]:
    return (_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu"))


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet (or whose library
    fails its sidecar's check), one ``nvcc`` each, all started together,
    each under its library's build lock (``libstore.locked``). Raises
    ``RuntimeError`` with the compiler's output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tool = toolchain()
    paths = {name: library_path(name) for name in names}
    jobs = {}
    with contextlib.ExitStack() as held:
        for name, out in sorted(paths.items()):  # one order everywhere: no two builders deadlock
            held.enter_context(libstore.locked(out))
            if libstore.usable(out, tool):
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
                libstore.seal(paths[name], tool)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed. A
    library the loader refuses is discarded and built once more; a second
    refusal raises ``RuntimeError``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            try:
                lib = libstore.open_library(lambda: build([name])[name])
            except OSError as err:
                raise RuntimeError(f"CUDA kernel library of {name} does not load after a rebuild: {err}") from err
            _LIBS[name] = lib
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


class StreamScratch:
    """Device memory a kernel keeps from call to call, one pair of byte
    buffers per (device, stream): ``zeroed``, made zero and left zero by
    every launch that uses it (tickets, a histogram cleared as it is read),
    and ``scratch``, which a launch writes before it reads.

    Keyed by the stream's raw handle, so two streams never share a buffer,
    and taken from torch's caching allocator on the calling stream, so a
    buffer replaced when it grows is reused only after the launches queued
    on that stream. A stream keeps buffers of the largest sizes it has asked
    for, up to :attr:`KEEP_BYTES` together; a call that needs more gets buffers
    of its own, freed when the call's tensors are. A stream whose handle may
    be reused once it is destroyed (``torch.cuda.ExternalStream``) must not
    be destroyed while calls made on it are queued: the next stream given the
    handle takes over its buffers. An entry is ``(zeroed, scratch,
    zeroed_ptr, zeroed_bytes, scratch_ptr, scratch_bytes)``; a caller holds
    it until its launch is queued.
    """

    #: what a stream keeps: 4 MiB holds the one-launch count's buffers at
    #: any T <= 4,095 and the multi-launch scan's up to about 260,000
    #: thresholds
    KEEP_BYTES = 4 << 20

    def __init__(self) -> None:
        self._buffers: Dict[Tuple[int, int], Tuple] = {}

    def get(self, device: int, stream: int) -> Optional[Tuple]:
        """The stream's entry, or None before its first call."""
        return self._buffers.get((device, stream))

    def grow(self, device: int, stream: int, zeroed_bytes: int, scratch_bytes: int, keep: bool = True) -> Tuple:
        """An entry with buffers of at least the given sizes for the stream:
        the kept one while it suffices, else new buffers (``zeroed`` zero),
        kept when they fit in :attr:`KEEP_BYTES`. ``keep=False`` (a launch
        recorded into a CUDA graph) always makes new buffers and keeps
        none: made inside the capture, they come from the graph's pool and
        their zero fill is a node of the graph, run at every replay, so no
        other graph or launch ever shares them."""
        import torch

        old = self._buffers.get((device, stream)) if keep else None
        if old is not None:
            if old[3] >= zeroed_bytes and old[5] >= scratch_bytes:
                return old
            zeroed_bytes, scratch_bytes = max(zeroed_bytes, old[3]), max(scratch_bytes, old[5])
        zeroed = torch.zeros(max(zeroed_bytes, 16), dtype=torch.uint8, device=device)
        scratch = torch.empty(max(scratch_bytes, 16), dtype=torch.uint8, device=device)
        entry = (zeroed, scratch, zeroed.data_ptr(), zeroed.numel(), scratch.data_ptr(), scratch.numel())
        if keep and zeroed.numel() + scratch.numel() <= self.KEEP_BYTES:
            self._buffers[(device, stream)] = entry
        return entry

    def drop(self, device: int, stream: int) -> None:
        """Forget the stream's buffers (after a failed launch, which may have
        left ``zeroed`` dirty); its next call makes new ones."""
        self._buffers.pop((device, stream), None)
