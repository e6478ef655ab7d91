"""The compile cache: a validated store of shape profiles, the background
worker and the manifests.

The JAX package keeps serialised executables and XLA's persistent cache on
disk. A CUDA graph cannot be written to disk, so neither has a counterpart
here. What a restarted port process pays for is different: the ``nvcc``
build of each hand-written kernel on its first launch, and, for each
executor key, an eager run and the capture of its graphs. So the port's
cache holds two things:

- **The kernel libraries**, in the package's ``_build/``, named by a hash of
  their sources and toolchain and loaded only when the sidecar beside each
  vouches for it (``native/libstore.py``): a damaged one costs one build.
  ``TORCHMETRICS_TPU_COMPILE_AHEAD=0`` never turns this off: the kernels
  need their libraries.
- **A store of shape profiles**: one entry an executor owner (a metric's or
  a collection's class, source hash, state layout and configuration, the
  toolchain and the backend), holding the specs of the keys its executors
  built, each with the launches one replay of it made. An executor's first
  call builds every recorded key before it dispatches: on the worker when
  background compilation is on, inline otherwise. An entry is written with
  ``io.checkpoint.atomic_write_bytes``; a torn, corrupt or stale one is
  warned about, deleted and read as a miss, and a recorded spec whose
  capture makes other launches than its record evicts the entry. The worst
  a poisoned store can do is cost the captures it would have saved.

And the same three pieces as the JAX package's, in its order: the store,
the :class:`CompileWorker` (one daemon thread, a bounded queue: background
captures of cold keys and the store's writes), and the shape-profile
manifests (:func:`save_shape_manifest`, :func:`load_shape_manifest`), in the
JAX package's format, so either package warms from the other's.

Environment flags, the JAX package's names, defaults and parsing:

- ``TORCHMETRICS_TPU_COMPILE_AHEAD=0``: no store reads or writes and no
  background captures (the libraries are still built and checked);
- ``TORCHMETRICS_TPU_CACHE_DIR``: the store's location (default
  ``~/.cache/torchmetrics_tpu_torch``, never the JAX package's);
- ``TORCHMETRICS_TPU_BG_COMPILE=1``: cold keys are served by the eager
  update while their capture runs on the worker (off by default). While
  the worker captures, a device-wide ``torch.cuda.synchronize()`` on any
  thread raises (CUDA forbids it during a capture): synchronise a stream;
- ``TORCHMETRICS_TPU_CACHE_MAX_BYTES``: the store's size cap (512 MiB,
  oldest entries evicted first).
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_warn

COMPILE_AHEAD_ENV = "TORCHMETRICS_TPU_COMPILE_AHEAD"
CACHE_DIR_ENV = "TORCHMETRICS_TPU_CACHE_DIR"
BG_COMPILE_ENV = "TORCHMETRICS_TPU_BG_COMPILE"
CACHE_MAX_BYTES_ENV = "TORCHMETRICS_TPU_CACHE_MAX_BYTES"

#: store-entry file magic (8 bytes and a newline; the container's version)
ENTRY_MAGIC = b"TMTHPRF1\n"

#: entry header schema version
ENTRY_VERSION = 1

#: store-entry filename suffix
ENTRY_SUFFIX = ".tmx"

#: the store's subdirectory of the cache directory
STORE_SUBDIR = "profiles"

#: an entry's one section: the owner's description and its recorded specs
SECTION_PROFILE = "shape_profile"

#: shape-profile manifest schema version (the JAX package's)
PROFILE_VERSION = 1

DEFAULT_CACHE_MAX_BYTES = 512 * 1024 * 1024

_FALSEY = ("0", "false", "off", "no")


def compile_ahead_enabled() -> bool:
    """Master switch of the store and the background captures
    (``TORCHMETRICS_TPU_COMPILE_AHEAD``, on by default)."""
    return os.environ.get(COMPILE_AHEAD_ENV, "1").strip().lower() not in _FALSEY


def background_compile_default() -> bool:
    """Whether cold executor keys capture on the background worker by default
    (``TORCHMETRICS_TPU_BG_COMPILE``, off by default: it changes a cold
    key's first call from "build, then serve" to "serve eagerly, swap in
    later")."""
    return os.environ.get(BG_COMPILE_ENV, "0").strip().lower() not in _FALSEY


def cache_dir() -> Optional[str]:
    """The resolved cache directory, or None when the layer is off."""
    if not compile_ahead_enabled():
        return None
    configured = os.environ.get(CACHE_DIR_ENV, "").strip()
    if configured:
        return os.path.expanduser(configured)
    return os.path.join(os.path.expanduser("~"), ".cache", "torchmetrics_tpu_torch")


def cache_max_bytes() -> int:
    raw = os.environ.get(CACHE_MAX_BYTES_ENV, "").strip()
    try:
        return int(raw) if raw else DEFAULT_CACHE_MAX_BYTES
    except ValueError:
        rank_zero_debug(f"torchmetrics_tpu_torch compile cache: bad {CACHE_MAX_BYTES_ENV}={raw!r}; using default")
        return DEFAULT_CACHE_MAX_BYTES


# --------------------------------------------------------------- fingerprints

_SOURCE_HASH_CACHE: Dict[Any, str] = {}
_sha = lambda data: hashlib.sha256(data).hexdigest()  # noqa: E731


def source_hash(obj: Any) -> str:
    """Cached sha256 of ``inspect.getsource(obj)`` (``"unknown"`` when the
    source is unavailable)."""
    cached = _SOURCE_HASH_CACHE.get(obj)
    if cached is None:
        try:
            cached = _sha(inspect.getsource(obj).encode())[:16]
        except (OSError, TypeError):
            cached = "unknown"
        _SOURCE_HASH_CACHE[obj] = cached
    return cached


def toolchain_fingerprint() -> str:
    """Versions and code identity shared by every entry: a torch or CUDA
    bump, or an edit to the executor or this module, invalidates them all."""
    cached = _SOURCE_HASH_CACHE.get("__toolchain__")
    if cached is None:
        from torchmetrics_tpu_torch import __version__
        from torchmetrics_tpu_torch.ops import executor as executor_mod

        cached = "|".join(
            (
                f"tm_torch={__version__}",
                f"torch={torch.__version__}",
                f"cuda={torch.version.cuda}",
                f"executor={source_hash(executor_mod)}",
                f"compile_cache={source_hash(inspect.getmodule(toolchain_fingerprint))}",
            )
        )
        _SOURCE_HASH_CACHE["__toolchain__"] = cached
    return cached


def backend_fingerprint(device: Any = None) -> str:
    """``cuda/<device name>/sm_<major><minor>`` on the card, ``cpu/cpu`` off
    it: graphs are built for one device kind."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available() else (device or "cpu"))
    if dev.type != "cuda":
        return "cpu/cpu"
    try:
        index = torch.cuda.current_device() if dev.index is None else dev.index
        major, minor = torch.cuda.get_device_capability(index)
        return f"cuda/{torch.cuda.get_device_name(index)}/sm_{major}{minor}"
    except Exception as err:  # probing must never break a dispatch
        rank_zero_debug(f"torchmetrics_tpu_torch compile cache: backend probe failed ({err})")
        return "cuda/unknown/unknown"


def entry_key(key_desc: str) -> str:
    """Content hash naming the on-disk entry of a fully described owner."""
    return _sha(key_desc.encode())[:32]


# ----------------------------------------------------------------- disk store


def entry_path(key_hash: str, directory: Optional[str] = None) -> Optional[str]:
    directory = directory if directory is not None else cache_dir()
    if directory is None:
        return None
    return os.path.join(directory, STORE_SUBDIR, f"{key_hash}{ENTRY_SUFFIX}")


def _entry_bytes(key_desc: str, sections: List[Tuple[str, bytes]], backend: str) -> bytes:
    payload = b"".join(blob for _, blob in sections)
    header = {
        "entry_version": ENTRY_VERSION,
        "sections": [{"format": fmt, "len": len(blob), "sha256": _sha(blob)} for fmt, blob in sections],
        "toolchain": toolchain_fingerprint(),
        "backend": backend,
        "key_desc_sha256": _sha(key_desc.encode()),
        "created_unix": time.time(),
        "payload_len": len(payload),
        "payload_sha256": _sha(payload),
    }
    header_bytes = json.dumps(header, sort_keys=True).encode()
    return ENTRY_MAGIC + len(header_bytes).to_bytes(8, "little") + header_bytes + payload


def store_entry(
    key_desc: str, sections: Any, directory: Optional[str] = None, backend: Optional[str] = None
) -> Optional[str]:
    """Atomically write one entry's sections (``[(format, blob), ...]`` or
    one ``(format, blob)`` pair) for ``backend`` (default: this process's,
    :func:`backend_fingerprint`); the path written, or None when the store
    is off or the write failed (never raises). Prunes the store to its cap
    after a write."""
    if sections and isinstance(sections[0], str):
        sections = [tuple(sections)]
    if not sections:
        return None
    path = entry_path(entry_key(key_desc), directory)
    if path is None:
        return None
    from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes

    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write_bytes(path, _entry_bytes(key_desc, list(sections), backend or backend_fingerprint()))
    except OSError as err:
        rank_zero_debug(f"torchmetrics_tpu_torch compile cache: store failed for {path} ({err})")
        return None
    prune_store(os.path.dirname(path))
    return path


class CacheEntryInvalid(ValueError):
    """An on-disk entry failed validation (torn, corrupt, stale toolchain or
    backend). Always handled: the loader warns, deletes and reports a miss."""


def _parse_entry(path: str, data: bytes, key_desc: str, backend: str) -> List[Tuple[str, bytes]]:
    if len(data) < len(ENTRY_MAGIC) + 8 or not data.startswith(ENTRY_MAGIC):
        raise CacheEntryInvalid(f"{path}: bad magic / truncated header")
    hlen = int.from_bytes(data[len(ENTRY_MAGIC):len(ENTRY_MAGIC) + 8], "little")
    h_start = len(ENTRY_MAGIC) + 8
    if hlen <= 0 or h_start + hlen > len(data):
        raise CacheEntryInvalid(f"{path}: header length {hlen} exceeds file size (torn write)")
    try:
        header = json.loads(data[h_start:h_start + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise CacheEntryInvalid(f"{path}: header is not valid JSON ({err})") from err
    if not isinstance(header, dict):
        raise CacheEntryInvalid(f"{path}: header is not a JSON object")
    version = header.get("entry_version")
    if not isinstance(version, int) or version > ENTRY_VERSION:
        raise CacheEntryInvalid(f"{path}: entry_version {version!r} unsupported (reads <= {ENTRY_VERSION})")
    if header.get("toolchain") != toolchain_fingerprint():
        raise CacheEntryInvalid(f"{path}: stale toolchain {header.get('toolchain')!r}")
    if header.get("backend") != backend:
        raise CacheEntryInvalid(f"{path}: entry built for backend {header.get('backend')!r}")
    if header.get("key_desc_sha256") != _sha(key_desc.encode()):
        raise CacheEntryInvalid(f"{path}: key description mismatch (hash collision or key-logic drift)")
    payload = data[h_start + hlen:]
    if len(payload) != header.get("payload_len"):
        raise CacheEntryInvalid(
            f"{path}: payload is {len(payload)} bytes, header promises {header.get('payload_len')} (torn write)"
        )
    if _sha(payload) != header.get("payload_sha256"):
        raise CacheEntryInvalid(f"{path}: payload sha256 mismatch (corrupt write / bit rot)")
    section_meta = header.get("sections")
    if not isinstance(section_meta, list) or not section_meta:
        raise CacheEntryInvalid(f"{path}: entry has no sections")
    sections: List[Tuple[str, bytes]] = []
    offset = 0
    for meta in section_meta:
        if not isinstance(meta, dict) or meta.get("format") != SECTION_PROFILE or not isinstance(meta.get("len"), int):
            raise CacheEntryInvalid(f"{path}: malformed section {meta!r}")
        fmt, length = meta["format"], meta["len"]
        blob = payload[offset:offset + length]
        if len(blob) != length or _sha(blob) != meta.get("sha256"):
            raise CacheEntryInvalid(f"{path}: section {fmt!r} sha256/length mismatch")
        sections.append((fmt, blob))
        offset += length
    if offset != len(payload):
        raise CacheEntryInvalid(f"{path}: {len(payload) - offset} trailing payload bytes")
    return sections


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        rank_zero_debug(f"torchmetrics_tpu_torch compile cache: could not delete {path}")


def load_entry(
    key_desc: str, directory: Optional[str] = None, backend: Optional[str] = None
) -> Optional[List[Tuple[str, bytes]]]:
    """Validated sections ``[(format, blob), ...]`` of ``key_desc``'s entry,
    or None on a miss. A damaged or stale entry (another toolchain, or
    another backend than ``backend``, default this process's) is warned
    about, deleted and reported as a miss."""
    path = entry_path(entry_key(key_desc), directory)
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as fh:
            data = fh.read()
        return _parse_entry(path, data, key_desc, backend or backend_fingerprint())
    except CacheEntryInvalid as err:
        rank_zero_warn(f"torchmetrics_tpu_torch compile cache: skipping damaged/stale entry ({err}); building fresh")
        _unlink(path)
        return None
    except OSError as err:
        rank_zero_debug(f"torchmetrics_tpu_torch compile cache: read failed for {path} ({err})")
        return None


def evict_entry(key_desc: str, directory: Optional[str] = None) -> None:
    """Delete ``key_desc``'s entry (a wrong one: see the executor)."""
    path = entry_path(entry_key(key_desc), directory)
    if path is not None and os.path.exists(path):
        _unlink(path)


def prune_store(directory: str, max_bytes: Optional[int] = None) -> int:
    """Evict the oldest entries (by mtime) until the store fits its cap; the
    number removed. Never fatal."""
    max_bytes = cache_max_bytes() if max_bytes is None else max_bytes
    try:
        entries = []
        with os.scandir(directory) as it:
            for de in it:
                if de.name.endswith(ENTRY_SUFFIX) and de.is_file():
                    st = de.stat()
                    entries.append((st.st_mtime, st.st_size, de.path))
    except OSError:
        return 0
    total = sum(size for _, size, _ in entries)
    removed = 0
    for _, size, path in sorted(entries):
        if total <= max_bytes:
            break
        try:
            os.unlink(path)
            total -= size
            removed += 1
        except OSError:
            rank_zero_debug(f"torchmetrics_tpu_torch compile cache: could not evict {path}")
    return removed


def store_profile(
    key_desc: str, profile: Dict[str, Any], backend: Optional[str] = None, directory: Optional[str] = None
) -> Optional[str]:
    """Write an owner's profile (``{"owner", "specs"}``) as its entry."""
    blob = json.dumps(profile, sort_keys=True).encode()
    return store_entry(key_desc, [(SECTION_PROFILE, blob)], directory, backend)


def load_profile(
    key_desc: str, backend: Optional[str] = None, directory: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """An owner's recorded profile, or None on a miss (a damaged entry, or
    one whose section is no profile, is warned about, deleted and missed)."""
    sections = load_entry(key_desc, directory, backend)
    if sections is None:
        return None
    try:
        profile = json.loads(sections[0][1].decode())
        if not isinstance(profile, dict) or not isinstance(profile.get("specs"), list):
            raise ValueError("no 'specs' list")
        return profile
    except (UnicodeDecodeError, ValueError) as err:
        rank_zero_warn(f"torchmetrics_tpu_torch compile cache: skipping damaged/stale entry (its profile: {err}); building fresh")
        evict_entry(key_desc, directory)
        return None


# ----------------------------------------------------------- background worker


class CompileWorker:
    """One daemon thread and a bounded queue running capture and store jobs.

    Jobs are plain callables. A job that raises is counted (``stats``) and
    logged, and never propagates: background work backs a correct eager
    path, so its failures cost only speed. :meth:`submit` never blocks: a
    full queue drops the job (counted), and the executor builds inline
    instead. Jobs touch detached copies of their owners, zero dummies and the
    store, never a live metric's state.
    """

    def __init__(self, maxsize: int = 16) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)  # (job, trace ctx) pairs
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._atexit_registered = False
        self.stats = {"submitted": 0, "dropped": 0, "completed": 0, "errors": 0}

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="tm_tpu_compile_worker", daemon=True)
                self._thread.start()
                if not self._atexit_registered:
                    # daemon, so a hung job never wedges shutdown; but the
                    # interpreter's teardown freezing it mid-capture would
                    # leave the device stream capturing: drain in-flight
                    # jobs at exit, bounded so a wedged one only delays it
                    import atexit

                    atexit.register(self.drain, 30.0)
                    self._atexit_registered = True

    def _run(self) -> None:
        from torchmetrics_tpu_torch import obs

        while True:
            job, ctx = self._q.get()
            try:
                # reopen the submitting thread's trace context: the job's
                # spans carry the enqueue site's trace id
                with obs.use_context(ctx):
                    job()
                self.stats["completed"] += 1
                obs.counter_inc("compile_worker.completed")
            except Exception as err:
                self.stats["errors"] += 1
                obs.counter_inc("compile_worker.errors")
                obs.fault_breadcrumb(
                    "compile_worker_job_failed", domain="compile", data={"error": f"{type(err).__name__}: {err}"}
                )
                rank_zero_debug(f"torchmetrics_tpu_torch compile worker: job failed ({type(err).__name__}: {err})")
            finally:
                self._q.task_done()
                obs.gauge_set("compile_worker.pending", self._q.unfinished_tasks)

    def submit(self, job: Callable[[], None]) -> bool:
        """Enqueue without blocking; False when the bounded queue is full.
        Carries the caller's trace context to the job."""
        from torchmetrics_tpu_torch import obs

        try:
            self._q.put_nowait((job, obs.capture_context()))
        except queue.Full:
            self.stats["dropped"] += 1
            obs.counter_inc("compile_worker.dropped")
            return False
        self.stats["submitted"] += 1
        obs.counter_inc("compile_worker.submitted")
        obs.gauge_set("compile_worker.pending", self._q.unfinished_tasks)
        self._ensure_thread()
        return True

    def pending(self) -> int:
        return self._q.unfinished_tasks

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every submitted job finished; True when the queue
        drained within ``timeout``."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True


_WORKER: Optional[CompileWorker] = None
_WORKER_LOCK = threading.Lock()


def get_worker() -> CompileWorker:
    """The process-wide worker (created on first use)."""
    global _WORKER
    with _WORKER_LOCK:
        if _WORKER is None:
            _WORKER = CompileWorker()
        return _WORKER


def drain_worker(timeout: float = 60.0) -> bool:
    """Wait for every in-flight background capture and store write (True at
    once when the worker never started)."""
    with _WORKER_LOCK:
        worker = _WORKER
    return True if worker is None else worker.drain(timeout)


# ------------------------------------------------------ shape-profile manifests


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def spec_of_call(kind: str, args: tuple, kwargs: dict) -> Optional[Dict[str, Any]]:
    """JSON-able description of one call's input shapes, or None when it
    cannot be replayed from a manifest (nested structures, leaves other than
    tensors and bools). The JAX package's format: ``{"kind", "args": [...],
    "kwargs": {...}}``, a leaf ``{"shape", "dtype"}`` or ``{"bool"}``."""

    def leaf(v: Any) -> Optional[Dict[str, Any]]:
        if type(v) is bool:
            return {"bool": v}
        if isinstance(v, torch.Tensor):
            return {"shape": [int(s) for s in v.shape], "dtype": _dtype_name(v.dtype)}
        return None

    arg_specs = [leaf(a) for a in args]
    kw_specs = {k: leaf(v) for k, v in kwargs.items()}
    if any(s is None for s in arg_specs) or any(s is None for s in kw_specs.values()):
        return None
    return {"kind": kind, "args": arg_specs, "kwargs": kw_specs}


def dummy_from_spec(spec: Dict[str, Any], device: Any = "cpu") -> Tuple[tuple, dict]:
    """Zero-filled ``(args, kwargs)`` on ``device`` matching a recorded spec
    (only shapes and dtypes key an executor)."""

    def leaf(s: Dict[str, Any]) -> Any:
        if "bool" in s:
            return bool(s["bool"])
        if "scalar" in s:
            return s["scalar"]
        return torch.zeros(tuple(s["shape"]), dtype=getattr(torch, s["dtype"]), device=device)

    return tuple(leaf(s) for s in spec.get("args", ())), {k: leaf(s) for k, s in spec.get("kwargs", {}).items()}


def save_shape_manifest(path: str, manifest: Dict[str, Any]) -> str:
    """Atomically write a shape-profile manifest (JSON) for
    ``warmup_from_manifest`` in a later process."""
    from torchmetrics_tpu_torch.io.checkpoint import atomic_write_bytes

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    atomic_write_bytes(path, json.dumps(manifest, sort_keys=True, indent=1).encode())
    return path


def load_shape_manifest(path: str) -> Dict[str, Any]:
    """Parse and check a shape-profile manifest."""
    with open(path, "rb") as fh:
        manifest = json.loads(fh.read().decode())
    version = manifest.get("profile_version")
    if not isinstance(version, int) or version > PROFILE_VERSION:
        raise ValueError(f"{path}: profile_version {version!r} unsupported (reads <= {PROFILE_VERSION})")
    if not isinstance(manifest.get("specs"), list):
        raise ValueError(f"{path}: manifest has no 'specs' list")
    return manifest
