"""Spawned ``torch.distributed`` gloo worlds for the port's sync tests.

:func:`run_world` starts ``world`` processes (the ``spawn`` method), each of
which joins a gloo process group through a ``file://`` store in a test's own
directory (never a TCP port, so parallel pytest workers cannot collide),
runs ``target(rank, world)`` and writes its picklable result to that
directory. The parent returns the results indexed by rank. A world that has
not finished within ``timeout`` seconds is killed and the test fails, so a
hang cannot stall the test run.

Each rank imports the module that defines ``target`` to find it, so that
module must import only torch, numpy and the port at its top level (JAX is
imported inside the test functions that compare against it).
"""
from __future__ import annotations

import multiprocessing
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List

import pytest


def _rank_main(rank: int, world: int, directory: str, target: Callable[[int, int], Any]) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(directory) / f"rank{rank}.pkl"
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{directory}/store", world_size=world, rank=rank
        )
        try:
            result = ("ok", target(rank, world))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_world(world: int, directory: Path, target: Callable[[int, int], Any], timeout: float = 120.0) -> List[Any]:
    """``target(rank, world)`` on every rank of a fresh gloo world; the results by rank."""
    directory.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(directory), target)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        pytest.fail(f"gloo world of {world}: ranks {hung} did not finish within {timeout}s (killed)")
    results = []
    for r, p in enumerate(procs):
        path = directory / f"rank{r}.pkl"
        if not path.exists():
            pytest.fail(f"gloo world of {world}: rank {r} exited with code {p.exitcode} and no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            pytest.fail(f"gloo world of {world}: rank {r} raised\n{value}")
        results.append(value)
    return results
