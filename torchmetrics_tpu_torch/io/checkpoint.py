"""Durable metric-state snapshots: atomic writes, validated restores, autosave.

The JAX package's container, byte for byte, so a snapshot either package
writes restores in the other wherever the two state specs agree:

- :func:`save_state` / :func:`restore_state`: one file holding a magic
  (``TMTPUCKv1\\n``), an 8-byte little-endian manifest length, a versioned
  JSON manifest and an ``npz`` payload with a sha256 per leaf, written
  write-to-temp, fsync, atomic rename, so a crash at any byte leaves either
  the previous snapshot or none, never a half-written one that parses.
- Rotating stores: ``save_state(..., keep=N)`` keeps the N newest
  ``snapshot-%08d.ckpt`` files in a directory; ``restore_state`` walks them
  newest-first and skips torn or corrupt files (typed
  :class:`CheckpointCorruptionError`) in favour of the newest valid one.
- :class:`Autosaver`: cadence-driven snapshots off the hot path. It stages
  ``state()``, references to the live state that no later update writes
  (eager updates replace tensors; the captured executor's slots are copied
  out first, ``Metric._escape_state``), so staging is a consistent snapshot
  at the cost of at most one copy; the device-to-host copy, the
  serialisation and the fsync'd write ride the async read pipeline's
  worker.
- :func:`install_preemption_handler`: a SIGTERM/SIGINT hook that flushes one
  final synchronous snapshot before the process dies.

Restores route through ``load_state(validate="strict")``. Leaves are
installed as tensors of their saved dtype on the target's device, with one
rule for snapshots of the JAX package, which keeps some counts in float32
where the port keeps int64 (the nominal table, Pearson's and concordance's
count): a float leaf restores into an integer state only when every value
is an integer float32 holds exactly (|v| <= 2^24, 2^53 for float64), and is
refused with :class:`StateCorruptionError` otherwise. After installing, the
state is re-fingerprinted against the manifest (``integrity.py``).

Topology (manifest v2): ``"strict"`` restores a snapshot whose layout
matches this world and refuses one that does not. The block binds a
stacked (deferred) snapshot to its shard count and a class-sharded one to
its class shard count. The restoring world's shard count is the caller's
``num_shards`` (the stacked shards this process steps; the port has no
mesh), else the CUDA device count. ``"elastic"`` re-splits instead of
refusing: a stacked snapshot goes through ``parallel/reshard.py`` onto
``num_shards`` shards (or is folded to the canonical reduced form when
``num_shards`` is None), and a class-layout change re-splits exactly
(gather to dense, re-stack) in ``load_state``. Each such restore counts
``checkpoint.elastic_restores``; its installed bits legitimately differ
from the saved ones, so only matching restores are re-fingerprinted.
"""
from __future__ import annotations

import hashlib
import inspect
import io as _io
import json
import os
import re
import signal as _signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.integrity import host_leaf_fingerprint
from torchmetrics_tpu_torch.utils.exceptions import (
    CheckpointCorruptionError,
    StateCorruptionError,
    StateDivergenceError,
    TopologyMismatchError,
    TorchMetricsUserError,
)
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_warn

#: file magic: 10 bytes, includes the container version
_MAGIC = b"TMTPUCKv1\n"

#: manifest schema version; v2 added the ``topology`` block (v1 snapshots,
#: without it, still read, with a warning)
MANIFEST_VERSION = 2

#: valid ``restore_state`` topology policies
TOPOLOGY_POLICIES = ("strict", "elastic")

#: rotating-store snapshot filename pattern
_SNAP_RE = re.compile(r"^snapshot-(\d{8})\.ckpt$")

#: default rotation depth for rotating stores and the Autosaver
DEFAULT_KEEP = 3

#: reserved per-metric export keys
_COUNT_KEY = "_update_count"
_SHARDS_KEY = "_sharded_shards"
#: a laned metric's quarantine records (lanes.py), a uint8 JSON blob leaf
_LANE_QUARANTINE_KEY = "_lane_quarantine"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _world_topology() -> Dict[str, Any]:
    """The saving or restoring world: the CUDA device count and the
    ``torch.distributed`` world size and rank (1 and 0 without a process
    group). A module-level seam, so ``testing/faults.shrink_world`` and
    ``grow_world`` can simulate a restart on another world."""
    dist = torch.distributed
    initialised = dist.is_available() and dist.is_initialized()
    return {
        "device_count": torch.cuda.device_count(),
        "process_count": dist.get_world_size() if initialised else 1,
        "process_index": dist.get_rank() if initialised else 0,
    }


def _host_leaf(value: Any) -> np.ndarray:
    """A host copy of one leaf (a fresh array, never a view of live state)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    return np.array(value)


def host_copy_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """Host-side (numpy) deep copy of a state export. Reserved int leaves
    and list states keep their structure.

    >>> snap = host_copy_tree({"total": torch.ones(2), "_update_count": 3})
    >>> snap["_update_count"], snap["total"].shape
    (3, (2,))
    """
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = host_copy_tree(v)
        elif isinstance(v, (list, tuple)):
            out[k] = [_host_leaf(el) for el in v]
        elif isinstance(v, (int, float)) and not hasattr(v, "shape"):
            out[k] = v
        else:
            out[k] = _host_leaf(v)
    return out


# ---------------------------------------------------------------- flattening

def _flatten_export(state: Dict[str, Any]) -> Tuple[List[Tuple[Dict[str, Any], np.ndarray]], Dict[str, Any]]:
    """Split a (metric or collection) host export into array leaves + scalars.

    Each leaf is ``(path_descriptor, array)`` where the descriptor names the
    ``leader`` (collections), ``field`` and ``index`` (list-state elements);
    ``scalars`` mirrors the export's nesting with only the reserved int
    leaves (counts, shard marks) and the list lengths.
    """
    leaves: List[Tuple[Dict[str, Any], np.ndarray]] = []
    scalars: Dict[str, Any] = {}

    def visit(sub: Dict[str, Any], leader: Optional[str]) -> None:
        dst = scalars.setdefault(leader, {}) if leader is not None else scalars
        for field, value in sub.items():
            if isinstance(value, dict):
                if leader is not None:
                    raise TorchMetricsUserError(f"state export nests deeper than collection->metric at {field!r}")
                visit(value, field)
            elif field in (_COUNT_KEY, _SHARDS_KEY):
                dst[field] = int(np.asarray(value))
            elif isinstance(value, (list, tuple)):
                dst.setdefault("_list_fields", {})[field] = len(value)
                for i, el in enumerate(value):
                    leaves.append(({"leader": leader, "field": field, "index": i}, np.asarray(el)))
            else:
                leaves.append(({"leader": leader, "field": field, "index": None}, np.asarray(value)))

    visit(state, None)
    return leaves, scalars


def _unflatten_export(
    leaves: List[Tuple[Dict[str, Any], np.ndarray]], scalars: Dict[str, Any], nested: bool
) -> Dict[str, Any]:
    """Inverse of :func:`_flatten_export` (list elements arrive in saved order)."""
    state: Dict[str, Any] = {}

    def bucket(leader: Optional[str]) -> Dict[str, Any]:
        return state.setdefault(leader, {}) if nested else state

    for desc, arr in leaves:
        dst = bucket(desc["leader"])
        if desc["index"] is None:
            dst[desc["field"]] = arr
        else:
            dst.setdefault(desc["field"], []).append(arr)

    def attach(dst: Dict[str, Any], info: Dict[str, Any]) -> None:
        for field, n in (info.get("_list_fields") or {}).items():
            got = dst.setdefault(field, [])
            if len(got) != n:
                raise obs.flighted(CheckpointCorruptionError(
                    f"list state {field!r} expected {n} elements, payload holds {len(got)}"
                ), domain="checkpoint")
        for key in (_COUNT_KEY, _SHARDS_KEY):
            if key in info:
                dst[key] = int(info[key])

    if nested:
        for leader, info in scalars.items():
            attach(state.setdefault(leader, {}), info or {})
    else:
        attach(state, scalars)
    return state


# ------------------------------------------------------------------- writing

def _snapshot_bytes(obj: Any, state: Dict[str, Any], update_count: Optional[int]) -> bytes:
    """Serialize one snapshot: magic + manifest JSON + npz payload."""
    from torchmetrics_tpu_torch import __version__

    nested = any(isinstance(v, dict) for v in state.values())
    leaves, scalars = _flatten_export(state)

    payload_buf = _io.BytesIO()
    np.savez(payload_buf, **{f"leaf_{i:05d}": arr for i, (_, arr) in enumerate(leaves)})
    payload = payload_buf.getvalue()

    leaf_manifest = [
        {
            "key": f"leaf_{i:05d}",
            "leader": desc["leader"],
            "field": desc["field"],
            "index": desc["index"],
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": _sha256(np.ascontiguousarray(arr).tobytes()),
            # restore_state re-fingerprints the INSTALLED state against this;
            # the sha256 above only covers the bytes at rest
            "fingerprint": [int(w) for w in host_leaf_fingerprint(arr)],
        }
        for i, (desc, arr) in enumerate(leaves)
    ]

    try:
        spec = obj.state_spec()
    except Exception as err:  # objects without a spec (exotic wrappers) still snapshot
        rank_zero_debug(f"torchmetrics_tpu_torch checkpoint: no state_spec for {type(obj).__name__} ({err})")
        spec = None

    # laned objects (lanes.py) describe their occupancy in the manifest, so
    # load_manifest answers "how many sessions does this snapshot hold"
    # without touching the payload
    lanes = None
    status = getattr(obj, "lane_status", None)
    if isinstance(status, dict):
        lanes = {k: status.get(k) for k in ("capacity", "active", "compiled", "policy", "quarantined") if k in status}

    # windowed objects (windows.py) describe their ring in the manifest (W,
    # the open head slot and the clock), so load_manifest answers "which
    # windows does this snapshot hold" without touching the payload
    windows = None
    try:
        spec_fn = getattr(obj, "window_spec", None)
        if spec_fn is None:
            spec_fn = getattr(getattr(obj, "inner", None), "window_spec", None)
        if callable(spec_fn):
            ws = spec_fn()
            if isinstance(ws, dict):
                windows = {k: ws.get(k) for k in ("window", "lateness", "clock", "head", "compiled") if k in ws}
    except Exception as err:  # a broken window probe must not block the save
        rank_zero_debug(f"torchmetrics_tpu_torch checkpoint: window_spec probe failed ({err})")

    world = _world_topology()
    shard_counts = [
        int(sub[_SHARDS_KEY])
        for sub in ([scalars] if not nested else scalars.values())
        if isinstance(sub, dict) and _SHARDS_KEY in sub
    ]
    topology = {
        "topology_version": 1,
        "device_count": world["device_count"],
        "process_count": world["process_count"],
        "mesh_shape": None,
        "sharded": bool(shard_counts),
        "num_shards": max(shard_counts) if shard_counts else None,
        "lane_capacity": (lanes or {}).get("capacity"),
        "state_sharding": _class_shard_count_of(obj),
    }
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "library_version": __version__,
        "torch_version": torch.__version__,
        "created_unix": time.time(),
        "kind": "collection" if nested else "metric",
        "class": type(obj).__name__,
        "spec": spec,
        "lanes": lanes,
        "windows": windows,
        "topology": topology,
        "update_count": update_count,
        "reduce_policy": getattr(obj, "reduce_policy", None),
        "mesh": {
            "device_count": world["device_count"],
            "process_count": world["process_count"],
            "process_index": world["process_index"],
        },
        "scalars": scalars,
        "leaves": leaf_manifest,
        "payload_len": len(payload),
        "payload_sha256": _sha256(payload),
    }
    manifest_bytes = json.dumps(manifest, sort_keys=True).encode("utf-8")
    return _MAGIC + len(manifest_bytes).to_bytes(8, "little") + manifest_bytes + payload


def atomic_write_bytes(path: str, data: bytes) -> None:
    """write-to-temp, flush, fsync, atomic rename (+ best-effort dir fsync).

    A crash at any byte leaves either the complete previous file or a stray
    ``.tmp.*`` sibling ``os.replace`` never promoted: a reader never sees a
    prefix of ``data`` under the final name. Every on-disk payload of the
    port (snapshots, exported traces, flight dumps) goes through here.
    """
    directory = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp.{os.getpid()}.{threading.get_ident()}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # best-effort temp cleanup; the failure below is the story
        raise
    try:  # the rename itself must be durable, not just the bytes
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        rank_zero_debug(f"torchmetrics_tpu_torch checkpoint: directory fsync unavailable for {directory}")


def _list_snapshots(directory: str) -> List[Tuple[int, str]]:
    """Rotating-store snapshots as (sequence, path), oldest first."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _resolve_update_count(obj: Any, state: Dict[str, Any]) -> Optional[int]:
    if _COUNT_KEY in state:
        return int(np.asarray(state[_COUNT_KEY]))
    counts = [int(np.asarray(v[_COUNT_KEY])) for v in state.values() if isinstance(v, dict) and _COUNT_KEY in v]
    if counts:
        return max(counts)
    count = getattr(obj, "update_count", None)
    return int(count) if count is not None else None


def save_state(
    obj: Any,
    path: str,
    keep: Optional[int] = None,
    states: Optional[Dict[str, Any]] = None,
    sharded: bool = False,
) -> str:
    """Write a durable snapshot of ``obj``'s metric state; returns the path written.

    ``obj`` is a ``Metric`` or ``MetricCollection``. ``path`` names a file
    (one snapshot, atomically replaced) or, with ``keep=N`` or an existing
    directory, a rotating store of ``snapshot-<seq>.ckpt`` files of which the
    N newest are kept. ``states`` overrides the live state with an external
    state dict (host or device); ``sharded=True`` marks each (leader's)
    export with the stacked shard count of its first array leaf.

    The write is crash-atomic: a preemption mid-save can cost at most the
    newest snapshot, never an older valid one.
    """
    with obs.span(obs.SPAN_CKPT_SAVE, owner=type(obj).__name__):
        obs.counter_inc("checkpoint.saves")
        return _save_state_body(obj, path, keep, states, sharded)


def _mark_shards(sub: Dict[str, Any]) -> Dict[str, Any]:
    shards = next((int(v.shape[0]) for v in sub.values() if getattr(v, "ndim", 0) >= 1), None)
    if shards is None:
        raise TorchMetricsUserError("sharded=True but no array leaf carries a shard axis")
    return {**sub, _SHARDS_KEY: shards}


def _save_state_body(
    obj: Any, path: str, keep: Optional[int], states: Optional[Dict[str, Any]], sharded: bool
) -> str:
    if states is None:
        export = obj.state()
    else:
        export = {k: (dict(v) if isinstance(v, dict) else v) for k, v in states.items()}
        if sharded:
            if any(isinstance(v, dict) for v in export.values()):
                export = {leader: _mark_shards(sub) for leader, sub in export.items()}
            else:
                export = _mark_shards(export)
    export = host_copy_tree(export)
    data = _snapshot_bytes(obj, export, _resolve_update_count(obj, export))

    if keep is None and not os.path.isdir(path):
        atomic_write_bytes(path, data)
        return path

    keep = DEFAULT_KEEP if keep is None else int(keep)
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    os.makedirs(path, exist_ok=True)
    existing = _list_snapshots(path)
    seq = (existing[-1][0] + 1) if existing else 0
    target = os.path.join(path, f"snapshot-{seq:08d}.ckpt")
    atomic_write_bytes(target, data)
    for _, old in _list_snapshots(path)[:-keep]:
        try:
            os.unlink(old)
        except OSError:
            rank_zero_debug(f"torchmetrics_tpu_torch checkpoint: could not prune {old}")
    return target


# ------------------------------------------------------------------- reading

def load_manifest(path: str) -> Dict[str, Any]:
    """Parse and integrity-check just the manifest of a snapshot file."""
    manifest, _ = _read_file(path, want_payload=False)
    return manifest


def _corrupt(message: str) -> BaseException:
    return obs.flighted(CheckpointCorruptionError(message), domain="checkpoint")


def _read_file(path: str, want_payload: bool = True) -> Tuple[Dict[str, Any], Optional[bytes]]:
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError as err:
        raise _corrupt(f"cannot read snapshot {path}: {err}") from err
    if len(blob) < len(_MAGIC) + 8 or not blob.startswith(_MAGIC):
        raise _corrupt(f"{path} is not a torchmetrics_tpu snapshot (bad magic/truncated header)")
    mlen = int.from_bytes(blob[len(_MAGIC):len(_MAGIC) + 8], "little")
    m_start = len(_MAGIC) + 8
    if mlen <= 0 or m_start + mlen > len(blob):
        raise _corrupt(f"{path}: manifest length {mlen} exceeds file size (torn write)")
    try:
        manifest = json.loads(blob[m_start:m_start + mlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise _corrupt(f"{path}: manifest is not valid JSON ({err})") from err
    version = manifest.get("manifest_version")
    if not isinstance(version, int) or version > MANIFEST_VERSION:
        raise _corrupt(f"{path}: manifest_version {version!r} unsupported (this build reads <= {MANIFEST_VERSION})")
    payload = blob[m_start + mlen:]
    if len(payload) != manifest.get("payload_len"):
        raise _corrupt(
            f"{path}: payload is {len(payload)} bytes, manifest promises {manifest.get('payload_len')} (torn write)"
        )
    if _sha256(payload) != manifest.get("payload_sha256"):
        raise _corrupt(f"{path}: payload sha256 mismatch (corrupt/torn write)")
    return manifest, (payload if want_payload else None)


def _decode_state(path: str, manifest: Dict[str, Any], payload: bytes) -> Dict[str, Any]:
    try:
        archive = np.load(_io.BytesIO(payload), allow_pickle=False)
    except Exception as err:
        raise _corrupt(f"{path}: payload archive unreadable ({err})") from err
    leaves: List[Tuple[Dict[str, Any], np.ndarray]] = []
    for entry in manifest.get("leaves", []):
        key = entry["key"]
        if key not in archive.files:
            raise _corrupt(f"{path}: payload missing leaf {key} ({entry['field']!r})")
        arr = archive[key]
        if list(arr.shape) != entry["shape"] or str(arr.dtype) != entry["dtype"]:
            raise _corrupt(
                f"{path}: leaf {entry['field']!r} is {arr.dtype}{tuple(arr.shape)},"
                f" manifest promises {entry['dtype']}{tuple(entry['shape'])}"
            )
        if _sha256(np.ascontiguousarray(arr).tobytes()) != entry["sha256"]:
            raise _corrupt(f"{path}: leaf {entry['field']!r} sha256 mismatch (bit rot / corrupt write)")
        leaves.append(({"leader": entry["leader"], "field": entry["field"], "index": entry["index"]}, arr))
    return _unflatten_export(leaves, manifest.get("scalars") or {}, manifest.get("kind") == "collection")


def _exact_integers(path: str, field: str, arr: np.ndarray, dtype: str) -> np.ndarray:
    """A float leaf cast into an integer state: only when every value is an
    integer the float type holds exactly (the JAX package's float32 counts,
    exact up to 2^24)."""
    limit = 2.0 ** (np.finfo(arr.dtype).nmant + 1)
    finite = bool(np.isfinite(arr).all())
    if not (finite and bool((arr == np.round(arr)).all()) and bool((np.abs(arr) <= limit).all())):
        raise obs.flighted(StateCorruptionError(
            f"{path}: field {field!r} holds {arr.dtype} values that are not all integers within"
            f" +-{int(limit)} (where {arr.dtype} counts are exact), so they cannot restore into"
            f" this metric's {dtype} state"
        ), domain="checkpoint")
    return arr.astype(dtype)


def _to_tensors(path: str, obj: Any, state: Dict[str, Any]) -> Dict[str, Any]:
    """Decoded numpy leaves as tensors of their saved dtype on ``obj``'s
    device, but for the float-into-integer rule (see the module docstring)."""
    device = getattr(obj, "device", torch.device("cpu"))
    try:
        spec = obj.state_spec()
    except Exception:
        spec = None
    nested = any(isinstance(v, dict) for v in state.values())

    def fields_of(leader: Optional[str]) -> Dict[str, Any]:
        sub = (spec or {}).get(leader) if nested else spec
        return (sub or {}).get("fields", {}) if isinstance(sub, dict) else {}

    def leaf(field: str, arr: np.ndarray, fields: Dict[str, Any]) -> torch.Tensor:
        want = (fields.get(field) or {}).get("dtype")
        if want is not None and arr.dtype.kind == "f" and np.dtype(want).kind in "iu":
            arr = _exact_integers(path, field, arr, want)
        return torch.from_numpy(arr.copy(order="C")).to(device)  # ascontiguousarray would make a 0-d leaf 1-d

    def convert(sub: Dict[str, Any], fields: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for field, value in sub.items():
            if isinstance(value, list):
                out[field] = [leaf(field, el, fields) for el in value]
            elif isinstance(value, np.ndarray):
                out[field] = leaf(field, value, fields)
            else:
                out[field] = value
        return out

    if nested:
        return {leader: convert(sub, fields_of(leader)) for leader, sub in state.items()}
    return convert(state, fields_of(None))


def _class_shard_count_of(obj: Any) -> Optional[int]:
    """The class shard count of ``obj``'s layout (a metric or a collection
    member), or None when no field is class-sharded."""

    def probe(m: Any) -> Optional[int]:
        layouts = getattr(m, "_class_layouts", None) or {}
        counts = [int(lay.num_shards) for lay in layouts.values()]
        return max(counts) if counts else None

    count = probe(obj)
    if count is not None:
        return count
    for member in (getattr(obj, "_modules", None) or {}).values():
        count = probe(member)
        if count is not None:
            return count
    return None


def _check_topology(path: str, manifest: Dict[str, Any], obj: Any, topology: str, num_shards: Optional[int]) -> str:
    """Compare the snapshot's saved topology block with this world; returns
    ``"match"``, ``"legacy"`` (a v1 snapshot without the block), or under
    ``"elastic"`` the re-split to make: ``"fold"`` (a stacked snapshot onto
    the reduced layout), ``"reshard"`` (onto ``num_shards`` shards) or
    ``"class_reshard"`` (another class layout). Under ``"strict"`` a
    mismatch raises :class:`TopologyMismatchError`."""
    saved = manifest.get("topology")
    if saved is None:
        obs.counter_inc("checkpoint.legacy_topology_reads")
        rank_zero_warn(
            f"torchmetrics_tpu_torch checkpoint: {path} predates the topology block"
            " (manifest v1); restoring without topology validation; re-save to bind"
            " the snapshot to its world shape"
        )
        return "legacy"
    world = _world_topology()
    current_shards = int(num_shards) if num_shards is not None else world["device_count"]
    saved_class = saved.get("state_sharding")
    current_class = _class_shard_count_of(obj)
    if saved.get("sharded") and saved.get("num_shards") and saved["num_shards"] != current_shards:
        message = (
            f"{path} holds a {saved['num_shards']}-shard stacked state but this world"
            f" steps {current_shards} shard(s)"
        )
        data = {"saved_num_shards": saved["num_shards"], "num_shards": current_shards}
        current: Dict[str, Any] = dict(world, num_shards=current_shards)
        action = "fold" if num_shards is None else "reshard"
    elif saved_class != current_class:
        describe = lambda n: f"{n} class shard(s)" if n else "a dense (replicated) class layout"  # noqa: E731
        message = f"{path} holds state laid out in {describe(saved_class)} but this instance uses {describe(current_class)}"
        data = {"saved_class_shards": saved_class, "class_shards": current_class}
        current = {"class_shards": current_class}
        action = "class_reshard"
    else:
        return "match"
    if topology == "elastic":
        return action
    obs.counter_inc("checkpoint.topology_mismatches")
    obs.fault_breadcrumb("topology_mismatch", domain="checkpoint", data={"snapshot": os.path.basename(path), **data})
    message += "; restore on the saved topology, or with topology='elastic' to re-split through parallel/reshard.py"
    raise obs.flighted(TopologyMismatchError(message, saved=saved, current=current), domain="checkpoint")


def _reshard_export(obj: Any, state: Dict[str, Any], num_shards: int) -> Dict[str, Any]:
    """A stacked export re-split onto ``num_shards`` shards through the
    target's own ``reshard_state`` (per group leader for a collection); the
    reserved count rides along and the shard mark names the new count."""

    def one(metric: Any, sub: Dict[str, Any]) -> Dict[str, Any]:
        out = metric.reshard_state(sub, num_shards)
        for key in (_COUNT_KEY,):
            if key in sub:
                out[key] = sub[key]
        out[_SHARDS_KEY] = int(num_shards)
        return out

    modules = getattr(obj, "_modules", None)
    if modules is not None and all(isinstance(v, dict) for v in state.values()):
        return {leader: one(modules[leader], sub) for leader, sub in state.items()}
    return one(obj, state)


def _force_fold(obj: Any) -> None:
    """Fold any pending stacked install to the reduced layout now."""
    fold = getattr(obj, "_fold_pending", None)
    if callable(fold):
        fold()
        return
    for member in (getattr(obj, "_modules", None) or {}).values():
        member_fold = getattr(member, "_fold_pending", None)
        if callable(member_fold):
            member_fold()


def _verify_installed_state(path: str, manifest: Dict[str, Any], obj: Any) -> None:
    """Re-fingerprint the state ``obj`` installed against the manifest's
    pre-save fingerprints (older snapshots without them verify vacuously).
    Leaves whose installed shape or dtype differ from the saved ones (a
    float-to-integer restore) are legitimately transformed and skipped. A
    mismatch on an unchanged leaf raises :class:`StateDivergenceError`."""
    entries = {
        (e.get("leader"), e.get("field"), e.get("index")): e
        for e in manifest.get("leaves", [])
        if e.get("fingerprint")
    }
    if not entries:
        return
    try:
        installed = host_copy_tree(obj.state())
    except Exception as err:  # exotic wrappers without a state probe still restore
        rank_zero_debug(f"torchmetrics_tpu_torch checkpoint: install verify skipped for {type(obj).__name__} ({err})")
        return
    leaves, _ = _flatten_export(installed)
    for desc, arr in leaves:
        if desc["field"] == _LANE_QUARANTINE_KEY:
            # a JSON blob whose session order follows set iteration, so its
            # bytes are not canonical; decoding it validated the content
            continue
        entry = entries.get((desc["leader"], desc["field"], desc["index"]))
        if entry is None or list(arr.shape) != list(entry["shape"]) or str(arr.dtype) != entry["dtype"]:
            continue
        expected = [int(w) for w in entry["fingerprint"]]
        observed = [int(w) for w in host_leaf_fingerprint(arr)]
        if observed != expected:
            field = entry.get("field")
            obs.counter_inc("checkpoint.integrity_mismatches")
            obs.fault_breadcrumb(
                "checkpoint_integrity_mismatch",
                domain="integrity",
                data={
                    "snapshot": os.path.basename(path), "leader": entry.get("leader"), "field": field,
                    "expected": expected, "observed": observed,
                },
            )
            raise obs.flighted(
                StateDivergenceError(
                    f"{path}: installed state leaf {field!r} does not fingerprint-match the"
                    f" snapshot (expected {expected}, observed {observed}): the restore"
                    " installed different bits than were saved",
                    surface="restore", field=field, expected=tuple(expected), observed=tuple(observed),
                ),
                domain="integrity",
                snapshot=os.path.basename(path),
            )


def _restore_file(
    path: str, obj: Any, validate: str, check_finite: bool, topology: str, num_shards: Optional[int] = None
) -> Dict[str, Any]:
    manifest, payload = _read_file(path)
    if validate != "off" and manifest.get("class") not in (None, type(obj).__name__):
        raise obs.flighted(StateCorruptionError(
            f"{path} holds state for {manifest.get('class')!r}, not {type(obj).__name__!r} (use validate='off' to force)"
        ), domain="checkpoint")
    action = _check_topology(path, manifest, obj, topology, num_shards)
    state = _to_tensors(path, obj, _decode_state(path, manifest, payload))
    if action == "reshard":
        state = _reshard_export(obj, state, int(num_shards))
    # wrappers with their own state layouts override load_state without the
    # validate/check_finite kwargs: forward only what the target accepts
    params = inspect.signature(obj.load_state).parameters
    kwargs: Dict[str, Any] = {}
    if "validate" in params:
        kwargs["validate"] = validate
    if "check_finite" in params:
        kwargs["check_finite"] = check_finite
    obj.load_state(state, **kwargs)
    if action in ("match", "legacy"):
        _verify_installed_state(path, manifest, obj)
    else:
        if action == "fold":
            _force_fold(obj)
        obs.counter_inc("checkpoint.elastic_restores")
        rank_zero_debug(f"torchmetrics_tpu_torch checkpoint: elastic restore ({action}) of {path}")
    manifest["topology_action"] = action
    return manifest


def restore_state(
    path: str,
    obj: Any,
    validate: str = "strict",
    check_finite: bool = False,
    on_fallback: Optional[Callable[[str, Exception], None]] = None,
    topology: str = "strict",
    num_shards: Optional[int] = None,
) -> Dict[str, Any]:
    """Restore ``obj``'s state from a snapshot file or rotating store.

    Single file: integrity checks (magic, manifest, payload and per-leaf
    sha256) raise :class:`CheckpointCorruptionError`; the decoded state then
    goes through ``obj.load_state(validate=..., check_finite=...)``.
    ``topology`` is ``"strict"`` or ``"elastic"`` and ``num_shards`` the
    stacked shard count this process steps (see the module docstring): a
    strict restore raises :class:`TopologyMismatchError` on a layout this
    world does not hold as saved, an elastic one re-splits it.

    Rotating store (``path`` is a directory): snapshots are tried newest
    first; a torn, corrupt, invalid or topology-mismatched snapshot is
    skipped (``on_fallback(path, error)`` observes each skip, default a
    rank-zero warning) and the next older one is tried. Raises
    :class:`CheckpointCorruptionError` when none is restorable.

    Returns the restored snapshot's manifest, with ``"path"``,
    ``"fallbacks_skipped"`` and ``"topology_action"`` attached.
    """
    if topology not in TOPOLOGY_POLICIES:
        raise ValueError(f"topology must be one of {TOPOLOGY_POLICIES}, got {topology!r}")
    with obs.span(obs.SPAN_CKPT_RESTORE, owner=type(obj).__name__):
        obs.counter_inc("checkpoint.restores")
        return _restore_state_body(path, obj, validate, check_finite, on_fallback, topology, num_shards)


def _restore_state_body(
    path: str,
    obj: Any,
    validate: str,
    check_finite: bool,
    on_fallback: Optional[Callable[[str, Exception], None]],
    topology: str,
    num_shards: Optional[int],
) -> Dict[str, Any]:
    if not os.path.isdir(path):
        manifest = _restore_file(path, obj, validate, check_finite, topology, num_shards)
        manifest["path"] = path
        manifest["fallbacks_skipped"] = 0
        return manifest

    snaps = _list_snapshots(path)
    if not snaps:
        raise _corrupt(f"no snapshots found in rotating store {path}")
    skipped = 0
    errors: List[str] = []
    for _, snap in reversed(snaps):
        try:
            manifest = _restore_file(snap, obj, validate, check_finite, topology, num_shards)
        except (CheckpointCorruptionError, StateCorruptionError) as err:
            skipped += 1
            errors.append(f"{os.path.basename(snap)}: {type(err).__name__}: {err}")
            obs.counter_inc("checkpoint.restore_fallbacks")
            obs.fault_breadcrumb(
                "checkpoint_fallback",
                domain="checkpoint",
                data={"snapshot": os.path.basename(snap), "error": f"{type(err).__name__}: {err}"},
            )
            if on_fallback is not None:
                on_fallback(snap, err)
            else:
                rank_zero_warn(
                    f"torchmetrics_tpu_torch checkpoint: skipping damaged snapshot {snap}"
                    f" ({type(err).__name__}: {err}); falling back to the previous one"
                )
            continue
        manifest["path"] = snap
        manifest["fallbacks_skipped"] = skipped
        return manifest
    raise _corrupt(f"no valid snapshot in rotating store {path}; all {len(snaps)} damaged:\n  " + "\n  ".join(errors))


# ------------------------------------------------------------------ autosave

class Autosaver:
    """Cadence-driven durable snapshots of a live metric or collection.

    Attach to any ``Metric`` or ``MetricCollection``; after every committed
    top-level ``update``/``forward`` the cadence is checked and, when due, a
    snapshot lands in the rotating store at ``directory``::

        saver = Autosaver(metric, "/ckpt/acc", every_n_updates=100).attach()
        ...  # evaluation loop: saves trigger off committed updates
        saver.flush(); saver.detach()

    Cost model (the hot path must not feel the disk): a background save
    stages REFERENCES to the live state (free: updates replace tensors, never
    write into them) plus a CUDA event on the caller's current stream, and
    rides the async read pipeline (``ops/async_read.py``): its worker waits
    on the event, copies the state to the host, serialises, hashes and
    writes. If a save is still in flight when the next one triggers, the new
    one is SKIPPED (``stats["skipped_inflight"]``) rather than queued without
    bound. ``background=False`` saves inline.

    ``every_n_updates`` / ``every_s`` may be combined; whichever fires first
    wins and both clocks reset on a save. Loops that carry state outside the
    object call :meth:`step` with the external ``states``. The ``stats``
    keys are the JAX package's.

    ``reuse_recovery=True`` (default): where the captured executor replayed
    the last update, a save takes its recovery reference instead
    (``ops.executor.latest_recovery_snapshot``: the state slot that replay
    read, one committed update behind the live state, copied to the host
    without marking the state escaped, so the next update copies nothing
    in); ``stats["reused_recovery_snapshots"]`` counts them. Elsewhere (no
    replay, an eager call, an escaped state) the save stages the live state
    as above.
    """

    def __init__(
        self,
        obj: Any,
        directory: str,
        every_n_updates: Optional[int] = None,
        every_s: Optional[float] = None,
        keep: int = DEFAULT_KEEP,
        background: bool = True,
        reuse_recovery: bool = True,
    ) -> None:
        if every_n_updates is None and every_s is None:
            raise ValueError("Autosaver needs a cadence: every_n_updates and/or every_s")
        if every_n_updates is not None and every_n_updates < 1:
            raise ValueError(f"every_n_updates must be >= 1, got {every_n_updates}")
        if every_s is not None and every_s <= 0:
            raise ValueError(f"every_s must be > 0, got {every_s}")
        self.obj = obj
        self.directory = directory
        self.every_n_updates = every_n_updates
        self.every_s = every_s
        self.keep = keep
        self.background = background
        self.reuse_recovery = reuse_recovery
        self.stats: Dict[str, Any] = {
            "saves": 0,
            "skipped_inflight": 0,
            "reused_recovery_snapshots": 0,
            "async_rides": 0,
            "save_errors": 0,
            "last_path": None,
            "last_error": None,
            "last_save_unix": None,
        }
        self._updates_since_save = 0
        self._last_save_t = time.monotonic()
        self._inflight: Optional[Any] = None  # the read-pipeline future of a background save
        # re-entrant: the preemption handler's final_save may interrupt a
        # save_now on the main thread
        self._lock = threading.RLock()
        self._detach_fns: List[Callable[[], None]] = []

    def _inflight_alive(self) -> bool:
        return self._inflight is not None and not self._inflight.done()

    # ------------------------------------------------------------ observation
    def attach(self) -> "Autosaver":
        """Observe committed updates on the target (idempotent)."""
        if not self._detach_fns:
            self._detach_fns.append(self.obj.add_update_observer(self._on_update))
        return self

    def detach(self) -> None:
        for fn in self._detach_fns:
            fn()
        self._detach_fns.clear()

    def _on_update(self, _obj: Any) -> None:
        self._updates_since_save += 1
        self.maybe_save()

    def step(self, states: Optional[Dict[str, Any]] = None, sharded: bool = False) -> Optional[str]:
        """Manual cadence tick for loops not routed through update/forward.
        Returns the path written when a save triggered, else None."""
        self._updates_since_save += 1
        return self.maybe_save(states=states, sharded=sharded)

    # ----------------------------------------------------------------- saving
    def _due(self) -> bool:
        if self.every_n_updates is not None and self._updates_since_save >= self.every_n_updates:
            return True
        return self.every_s is not None and (time.monotonic() - self._last_save_t) >= self.every_s

    def maybe_save(self, states: Optional[Dict[str, Any]] = None, sharded: bool = False) -> Optional[str]:
        if not self._due():
            return None
        return self.save_now(states=states, sharded=sharded)

    def _write(self, export: Dict[str, Any], sharded: bool) -> None:
        try:
            written = save_state(self.obj, self.directory, keep=self.keep, states=export, sharded=sharded)
            self.stats["saves"] += 1
            self.stats["last_path"] = written
            self.stats["last_save_unix"] = time.time()
        except Exception as err:
            # an autosave failure must not kill the evaluation step; it is
            # recorded (and visible in stats) instead
            self.stats["save_errors"] += 1
            self.stats["last_error"] = f"{type(err).__name__}: {err}"
            obs.counter_inc("autosave.save_errors")
            obs.fault_breadcrumb("autosave_failed", domain="autosave", data={"error": f"{type(err).__name__}: {err}"})
            rank_zero_warn(f"torchmetrics_tpu_torch autosave failed: {type(err).__name__}: {err}")

    def save_now(self, states: Optional[Dict[str, Any]] = None, sharded: bool = False) -> Optional[str]:
        """Trigger a save now: stage on the calling thread, write on the read
        pipeline's worker (or inline when ``background=False``). Returns the
        store directory (background) or the snapshot path (inline), or None
        when skipped for an in-flight write."""
        from torchmetrics_tpu_torch.ops.async_read import get_pipeline, submission_event, wait_submitted

        with self._lock:
            if self._inflight_alive():
                self.stats["skipped_inflight"] += 1
                obs.counter_inc("autosave.skipped_inflight")
                return None
            # the autosave span covers exactly what the hot path pays: a
            # background save stages references and one CUDA event
            with obs.span(obs.SPAN_AUTOSAVE, owner=type(self.obj).__name__):
                obs.counter_inc("autosave.ticks")
                # captured inside the tick span: the background write's
                # checkpoint.save span reopens it (a flow arrow across threads)
                ctx = obs.capture_context()
                reused = None
                if states is None and self.reuse_recovery:
                    from torchmetrics_tpu_torch.ops.executor import latest_recovery_snapshot

                    reused = latest_recovery_snapshot(self.obj)
                if reused is not None:
                    # host arrays already, one committed update behind, the
                    # count key embedded; nothing staged on the device
                    self.stats["reused_recovery_snapshots"] += 1
                    staged, event = reused[1], None
                else:
                    staged = self.obj.state() if states is None else states
                    event = submission_event(staged) if self.background else None
                self._updates_since_save = 0
                self._last_save_t = time.monotonic()
            if not self.background:
                self._write(host_copy_tree(staged), sharded)
                return self.stats["last_path"]

            def ride() -> None:
                with obs.use_context(ctx):
                    wait_submitted(event)
                    # the staged references live in this closure until the
                    # host copy is done
                    self._write(host_copy_tree(staged), sharded)

            self.stats["async_rides"] += 1
            obs.counter_inc("autosave.async_rides")
            self._inflight = get_pipeline().submit(ride, owner=f"Autosaver({type(self.obj).__name__})")
        # the concrete snapshot path lands in stats["last_path"] once the
        # worker commits; the store directory is the stable address
        return self.directory

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until any in-flight background write completes."""
        inflight = self._inflight
        if inflight is not None:
            inflight.wait(timeout)

    def final_save(self) -> Optional[str]:
        """Synchronous last-gasp snapshot (the preemption-handler path): waits
        for any in-flight write, then saves the CURRENT live state inline (no
        recovery-snapshot reuse, no background write)."""
        self.flush()
        reuse, background = self.reuse_recovery, self.background
        self.reuse_recovery = self.background = False
        try:
            return self.save_now()
        finally:
            self.reuse_recovery, self.background = reuse, background


# -------------------------------------------------------------- preemption

class PreemptionHandle:
    """Installed signal hooks; ``uninstall()`` restores the previous handlers."""

    def __init__(self, saver: Autosaver, signums: Tuple[int, ...]) -> None:
        self._saver = saver
        self._previous: Dict[int, Any] = {}
        self.flushes = 0
        for signum in signums:
            self._previous[signum] = _signal.getsignal(signum)
            _signal.signal(signum, self._handle)

    def _handle(self, signum: int, frame: Any) -> None:
        self.flushes += 1
        try:
            self._saver.final_save()
        except Exception as err:  # the chained handler must still run on a failed flush
            rank_zero_warn(f"torchmetrics_tpu_torch preemption flush failed: {type(err).__name__}: {err}")
        previous = self._previous.get(signum)
        if callable(previous):
            previous(signum, frame)
        elif signum == _signal.SIGINT:
            raise KeyboardInterrupt
        elif previous is _signal.SIG_DFL:
            # re-deliver with the default disposition so exit codes stay honest
            _signal.signal(signum, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def uninstall(self) -> None:
        for signum, previous in self._previous.items():
            _signal.signal(signum, previous)
        self._previous.clear()


def install_preemption_handler(saver: Autosaver, signums: Optional[Tuple[int, ...]] = None) -> PreemptionHandle:
    """Flush one final snapshot when the process is told to die.

    Registers handlers for SIGTERM and SIGINT (override via ``signums``) that
    run ``saver.final_save()`` (synchronous, current live state) on the main
    thread between bytecodes, then chain to the previously installed handler
    or re-deliver the signal with the default disposition, so the process
    still dies by it. Must be called from the main thread; returns a handle
    whose ``uninstall()`` restores the previous handlers.
    """
    if signums is None:
        signums = (_signal.SIGTERM, _signal.SIGINT)
    return PreemptionHandle(saver, tuple(signums))
