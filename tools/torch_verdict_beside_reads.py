#!/usr/bin/env python3
"""How often the captured executor's verdict sends ImageNet-1k val's
collection key to the eager path when the key's timed replay runs beside
an asynchronous read, on an NVIDIA GPU.

Run from the root of a checkout::

    python3 tools/torch_verdict_beside_reads.py

The collection and its batches are ``chip_smoke.py``'s ``imagenet_val``
workload (1,000 classes, batches of 1,024, seeded). Each of 8 trials
builds a fresh executor collection (and an eager one updated beside it),
makes three updates (the groups, the fresh key, the first replay), then,
with ``pending`` true, submits one ``compute_async`` and makes ten more
updates while it resolves; with ``pending`` false the same ten updates
run with no read in flight. One JSON line a run: the trial, ``pending``,
how many keys the verdict ran eagerly and its reasons.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from torchmetrics_tpu_torch.ops import native  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_verdict_beside_reads: no CUDA device is available", file=sys.stderr)
        return 2
    native.build(cs.KERNELS)
    dev = torch.device("cuda", 0)
    spec = cs.WORKLOADS["imagenet_val"](dev)
    for trial in range(8):
        for pending in (True, False):
            on = spec["collection"](executor=True)
            off = spec["collection"](executor=False)
            gen = spec["batches"]()
            batches = [next(gen) for _ in range(4)]
            for b in batches[:3]:
                on.update(*b)
                off.update(*b)
            fut = on.compute_async() if pending else None
            for _ in range(10):
                on.update(*batches[3])
            torch.cuda.synchronize()
            if fut is not None:
                fut.result(60.0)
            eager = on.executor_status["stats"]["eager"]
            print(json.dumps({"trial": trial, "pending": pending, "eager_keys": eager["keys"], "reasons": eager["reasons"]}),
                  flush=True)
            del on, off, fut
    return 0


if __name__ == "__main__":
    sys.exit(main())
