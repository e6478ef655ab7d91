"""Kernel launch counts, per process and per thread.

Every kernel wrapper counts its launches with :func:`add`, which moves the
wrapper module's attribute (``bincount.launches`` and the rest: the process
totals that a run sets to 0 and reads) and the calling thread's own count.

A CUDA graph capture launches nothing, yet the bodies it records run
through the same wrappers. The executor's capture therefore runs inside
:func:`capture_scope`: while it lasts, the capturing thread's counts go to
the scope's record and never reach the totals. Launches that other threads
make meanwhile (the live loop's eager updates beside a background capture)
reach the totals as always and never enter the graph's per-replay count.

The hot path is cheap: the scope is a thread-local lookup, the thread's own
count is its own dict (no other thread writes it), and only the process
total takes a lock, uncontended unless two threads launch at once.

>>> import types, sys
>>> mod = types.ModuleType("launch_count_demo"); mod.launches = 0
>>> sys.modules["launch_count_demo"] = mod
>>> with capture_scope() as recorded:
...     add(mod, "launches", 2)
>>> mod.launches, recorded
(0, {('launch_count_demo', 'launches'): 2})
>>> add(mod, "launches", 1); mod.launches
1
>>> del sys.modules["launch_count_demo"]
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Tuple


class _Local(threading.local):
    #: the capture scope's record, while the thread is inside one
    scope = None
    #: the thread's own counts (made at its first count)
    counts = None


_LOCK = threading.Lock()
_LOCAL = _Local()
#: each thread's own counts, by thread ident: {(module name, attribute): n}
_THREADS: Dict[int, Dict[Tuple[str, str], int]] = {}


def _own() -> Dict[Tuple[str, str], int]:
    counts = _LOCAL.counts
    if counts is None:
        counts = _LOCAL.counts = {}
        with _LOCK:
            _THREADS[threading.get_ident()] = counts
    return counts


def add(module: Any, attr: str = "launches", n: int = 1) -> None:
    """Count ``n`` launches on ``module.<attr>`` and on the calling thread,
    or, inside the thread's :func:`capture_scope`, on the scope's record."""
    key = (module.__name__, attr)
    local = _LOCAL
    scope = local.scope
    if scope is not None:
        scope[key] = scope.get(key, 0) + n
        return
    own = local.counts
    if own is None:
        own = _own()
    own[key] = own.get(key, 0) + n
    _LOCK.acquire()  # not ``with``: half the cost on this path
    try:
        setattr(module, attr, getattr(module, attr) + n)
    finally:
        _LOCK.release()


def thread_counts() -> Dict[Tuple[str, str], int]:
    """A copy of the calling thread's counts."""
    return dict(_own())


def all_threads() -> Dict[int, Dict[Tuple[str, str], int]]:
    """Every thread's counts, by ident (a thread's stay until its ident is
    taken by a new thread)."""
    with _LOCK:
        threads = list(_THREADS.items())
    return {ident: dict(counts) for ident, counts in threads}


@contextmanager
def capture_scope() -> Iterator[Dict[Tuple[str, str], int]]:
    """Run a capture: the launches the calling thread counts inside the
    scope go to the yielded dict (``{(module name, attribute): n}``), not to
    the process totals or the thread's own count."""
    outer = _LOCAL.scope
    recorded: Dict[Tuple[str, str], int] = {}
    _LOCAL.scope = recorded
    try:
        yield recorded
    finally:
        _LOCAL.scope = outer
