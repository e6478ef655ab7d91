"""Kernel dispatch seam and the shared-result memo.

Every hand-written kernel in ``ops/`` registers here with a plain PyTorch
body and the body written for the GPU. :func:`dispatch` picks the body by the
DEVICE OF THE TENSORS it is given, not by a process-wide backend:

- CPU tensors run the plain body (the tests, and anyone who opts out of the
  card with ``device="cpu"``);
- CUDA tensors run the hand-written kernel, or the call raises when the
  kernel has no CUDA body. There is no size gate and no switch that sends a
  CUDA tensor to the plain body: gates come later, from measurements on the
  card.

Each decision is recorded in a gate log (:func:`gate_snapshot`), so a run can
show which body served it.

Shared-result memo: :func:`shared_result` lets several metrics updated
against the SAME input tensors within one collection call reuse a single
kernel result. The memo lives only inside an active :func:`shared_scope`
frame, which the collection opens around one update/forward, so no tensor
outlives the call that produced it (a process-global cache would pin whole
batches of logits on the card).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclass
class KernelSpec:
    """One registered kernel: its plain PyTorch body and its CUDA body."""

    name: str
    reference: Callable[..., Any]
    cuda: Optional[Callable[..., Any]] = None


_REGISTRY: Dict[str, KernelSpec] = {}
_GATE_LOG: Dict[str, Dict[str, Any]] = {}
_GATE_LOCK = threading.Lock()


def register_kernel(spec: KernelSpec) -> KernelSpec:
    """Register (or re-register) a kernel under ``spec.name``."""
    _REGISTRY[spec.name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    return _REGISTRY[name]


def registered_kernels() -> Dict[str, KernelSpec]:
    return dict(_REGISTRY)


def _record_gate(name: str, path: str, device: torch.device) -> None:
    with _GATE_LOCK:
        entry = _GATE_LOG.setdefault(name, {"selections": {}})
        entry["path"] = path
        entry["device"] = str(device)
        entry["selections"][path] = entry["selections"].get(path, 0) + 1


def gate_snapshot() -> Dict[str, Dict[str, Any]]:
    """Last decision plus per-path selection counts for every kernel that has
    dispatched in this process."""
    with _GATE_LOCK:
        return {k: dict(v, selections=dict(v["selections"])) for k, v in _GATE_LOG.items()}


def reset_gate_log() -> None:
    with _GATE_LOCK:
        _GATE_LOG.clear()


def dispatch(name: str, *args: Any, **kwargs: Any) -> Any:
    """Run kernel ``name`` on the body its tensors' device selects (see the
    module docstring). The first tensor argument names the device."""
    spec = _REGISTRY[name]
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    if device.type == "cpu":
        body, path = spec.reference, "reference"
    elif device.type == "cuda":
        if spec.cuda is None:
            raise RuntimeError(f"kernel {name!r} has no CUDA body; it cannot run on {device}")
        body, path = spec.cuda, "cuda"
    else:
        raise RuntimeError(f"kernel {name!r} runs on CPU or CUDA tensors, got {device}")
    _record_gate(name, path, device)
    return body(*args, **kwargs)


# ------------------------------------------------------ shared-result memo

_SCOPES = threading.local()


class shared_scope:
    """One fusion scope: shared results live exactly as long as the ``with``
    block that opened it. Nests; inner lookups see outer frames. The stack is
    thread-local."""

    def __enter__(self) -> "shared_scope":
        stack = getattr(_SCOPES, "stack", None)
        if stack is None:
            stack = _SCOPES.stack = []
        stack.append({})
        return self

    def __exit__(self, *exc: Any) -> None:
        _SCOPES.stack.pop()


def shared_result(tensors: Tuple[Any, ...], spec: Tuple[Any, ...], builder: Callable[[], Any]) -> Any:
    """``builder()`` memoized on the identity of ``tensors`` plus a config tuple.

    Inside an active :class:`shared_scope`, every compute-group leader of a
    collection receives the same tensor objects for ``(preds, target)``, so
    the first leader builds the shared counts and the rest reuse them: one
    kernel launch per update. A hit requires every key tensor to ``is``-match
    the stored one, so a reused Python id can never satisfy a lookup. Outside
    a scope nothing is memoized.
    """
    stack = getattr(_SCOPES, "stack", None)
    if not stack:
        return builder()
    key = tuple(id(t) for t in tensors) + tuple(spec)
    for frame in reversed(stack):
        hit = frame.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], tensors)):
            return hit[1]
    value = builder()
    stack[-1][key] = (tuple(tensors), value)
    return value
