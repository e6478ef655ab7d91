"""The store of built libraries: names, sidecars and the check before a load.

Both of the port's build paths use it: ``ops/native.py`` (the CUDA kernels,
``nvcc`` for ``sm_90a``) and ``native/__init__.py`` (the host C++ libraries,
``g++``).

- **Names.** A library is named by a hash of everything its bytes depend
  on: its sources, and the toolchain string (:func:`toolchain`: the
  compiler's own ``--version``, its flags and the target). A library that
  another toolkit or other flags built has another name, so it is never
  loaded as current.
- **Sidecars.** Beside every library a build writes lies
  ``<library>.json`` with the library's length, its sha256 and the
  toolchain string. It is written atomically, after the library's own
  rename.
- **The check.** A library is loaded only when its sidecar vouches for it
  (:func:`usable`). A library whose sidecar is missing, unreadable or names
  another toolchain, or whose bytes do not match it, is warned about once,
  naming the file and the reason, deleted, and rebuilt. The worst a damaged
  library can cost is one build.
- **The lock.** A build's check, compile, rename and seal run under an
  exclusive ``fcntl.flock`` on ``<library>.lock`` (:func:`locked`), so a
  process or thread that builds the same library at once waits, then finds
  it sealed, and never judges a library in the instant between its rename
  and its sidecar.
- **The load.** :func:`open_library` builds (if needed) and loads; a
  library the loader refuses is discarded and built once more.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import json
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

_VERSIONS: Dict[str, str] = {}
_VERSIONS_LOCK = threading.Lock()


def compiler_version(compiler: str) -> str:
    """The compiler's ``--version`` output (once a process per compiler), or
    ``"unavailable (...)"`` when it does not run."""
    with _VERSIONS_LOCK:
        cached = _VERSIONS.get(compiler)
        if cached is None:
            try:
                out = subprocess.run([compiler, "--version"], capture_output=True, text=True, timeout=60)
                cached = out.stdout.strip() if out.returncode == 0 else f"unavailable (exit {out.returncode})"
            except (OSError, subprocess.SubprocessError) as err:
                cached = f"unavailable ({type(err).__name__})"
            _VERSIONS[compiler] = cached
        return cached


def toolchain(compiler: str, flags: Sequence[str], target: str) -> str:
    """The toolchain string a library's name hashes and its sidecar holds."""
    return "|".join((f"compiler={compiler_version(compiler)}", f"flags={' '.join(flags)}", f"target={target}"))


def library_name(stem: str, sources: Iterable[Path], toolchain_str: str) -> str:
    """``<stem>-<16 hex digits>.so``, hashed on the sources and the toolchain."""
    digest = hashlib.sha256()
    for source in sources:
        digest.update(Path(source).read_bytes())
    digest.update(toolchain_str.encode())
    return f"{stem}-{digest.hexdigest()[:16]}.so"


def sidecar_path(library: Path) -> Path:
    return library.with_name(library.name + ".json")


@contextlib.contextmanager
def locked(library: Path) -> Iterator[None]:
    """Hold the exclusive build lock of ``library`` (``<library>.lock``
    beside it; its directory is made if missing)."""
    library.parent.mkdir(parents=True, exist_ok=True)
    with open(library.with_name(library.name + ".lock"), "a+b") as fh:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh.fileno(), fcntl.LOCK_UN)


def seal(library: Path, toolchain_str: str) -> None:
    """Write the sidecar of a library just built (after its rename)."""
    from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes

    data = library.read_bytes()
    record = {"length": len(data), "sha256": hashlib.sha256(data).hexdigest(), "toolchain": toolchain_str}
    atomic_write_bytes(str(sidecar_path(library)), json.dumps(record, sort_keys=True).encode())


def check(library: Path, toolchain_str: str) -> Optional[str]:
    """Why an existing library may not be loaded, or None when its sidecar
    vouches for it."""
    sidecar = sidecar_path(library)
    try:
        record = json.loads(sidecar.read_bytes().decode())
    except FileNotFoundError:
        return "no sidecar lies beside it"
    except (OSError, UnicodeDecodeError, ValueError) as err:
        return f"its sidecar is unreadable ({type(err).__name__}: {err})"
    if not isinstance(record, dict):
        return "its sidecar is unreadable (not a JSON object)"
    if record.get("toolchain") != toolchain_str:
        return f"its sidecar names another toolchain ({record.get('toolchain')!r})"
    try:
        data = library.read_bytes()
    except OSError as err:
        return f"it is unreadable ({type(err).__name__}: {err})"
    if len(data) != record.get("length"):
        return f"it is {len(data)} bytes where its sidecar says {record.get('length')}"
    if hashlib.sha256(data).hexdigest() != record.get("sha256"):
        return "its sha256 differs from its sidecar's"
    return None


def discard(library: Path, reason: str) -> None:
    """Warn about a damaged or stale library, then delete it and its sidecar."""
    warnings.warn(
        f"torchmetrics_tpu_torch: the built library {library} is damaged or stale ({reason}); deleting it and"
        " building it again",
        RuntimeWarning,
        stacklevel=3,
    )
    library.unlink(missing_ok=True)
    sidecar_path(library).unlink(missing_ok=True)


def usable(library: Path, toolchain_str: str) -> bool:
    """Whether ``library`` exists and its sidecar vouches for it. A library
    that exists and fails the check is discarded (:func:`discard`). Call it
    holding :func:`locked`: a build in progress elsewhere seals under it."""
    if not library.exists():
        return False
    reason = check(library, toolchain_str)
    if reason is None:
        return True
    discard(library, reason)
    return False


def open_library(build: Callable[[], Path]) -> ctypes.CDLL:
    """Build (``build`` returns the library's path, built if needed) and
    load a library. One the loader refuses is discarded and built once
    more; a second refusal raises ``OSError``."""
    path = build()
    try:
        return ctypes.CDLL(str(path))
    except OSError as err:
        with locked(path):
            discard(path, f"the loader refused it: {err}")
    return ctypes.CDLL(str(build()))
