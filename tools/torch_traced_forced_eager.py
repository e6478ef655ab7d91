#!/usr/bin/env python3
"""``chip_smoke.py``'s traced ImageNet-1k val pass with the executor's
verdict as it falls and with every verdict forced eager, on an NVIDIA GPU.

Run from the root of a checkout, or name another checkout's root::

    python3 tools/torch_traced_forced_eager.py [ROOT]

The collection and its batches are ``chip_smoke.py``'s ``imagenet_val``
workload (1,000 classes, 48 batches of 1,024 and one of 848, seeded). For
each verdict (``force_eager`` false, then true: ``_KEEP_SHARE`` below 0, so
no replay is fast enough) and each of the traced phase's four modes
(telemetry and tracing off and on, device-completion observations), a fresh
collection takes the 49 updates. One JSON line a run: the ``bincount``
launches, the executor's calls, its fallback reason and eager keys, and in
the traced modes the update and dispatch spans that the phase counts. A
capture that fails prints its traceback first. The compile cache's store
is off; its directory, ``ROOT/_forced_eager_cache``, is removed at the end.
"""
import json
import logging
import os
import shutil
import sys
import traceback
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    cache = root / "_forced_eager_cache"
    os.environ["TORCHMETRICS_TPU_CACHE_DIR"] = str(cache)
    os.environ["TORCHMETRICS_TPU_COMPILE_AHEAD"] = "0"
    import torch

    if not torch.cuda.is_available():
        print("torch_traced_forced_eager: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.ops import executor as ex

    logging.basicConfig(stream=sys.stdout, level=logging.WARNING)
    capture = ex._Dispatcher._capture

    def traced_capture(self, *args, **kwargs):
        try:
            return capture(self, *args, **kwargs)
        except BaseException:
            print("capture failed:\n" + traceback.format_exc(), flush=True)
            raise

    ex._Dispatcher._capture = traced_capture
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = cs._imagenet_indexed(dev)
    batches = list(spec["batches"]())
    keep = ex._KEEP_SHARE
    modes = {"flags_off": (False, False, False), "telemetry": (True, False, False), "traced": (True, True, False),
             "traced_ready": (True, True, True)}
    try:
        for force in (False, True):
            ex._KEEP_SHARE = -1.0 if force else keep
            for mode, (telemetry, tracing, ready) in modes.items():
                obs.set_telemetry(telemetry)
                obs.set_tracing(tracing)
                obs.reset()
                obs.reset_ring()
                obs.reset_flight()
                coll = spec["collection"]()
                torch.cuda.synchronize()
                bincount.launches = 0
                for preds, target in batches:
                    coll.update(preds, target)
                    if ready:
                        obs.observe_ready("imagenet_val.update.ready", coll["confmat"].confmat)
                coll.compute()
                torch.cuda.synchronize()
                stats = coll.executor_status["stats"]
                out = {"force_eager": force, "mode": mode, "launches": bincount.launches, "calls": stats["calls"],
                       "fallback": stats.get("fallback_reason"), "eager_keys": stats["eager"]["keys"],
                       "eager_calls": stats["eager"]["calls"], "compiles": stats["compiles"]}
                if tracing:
                    obs.flush_ready_observations(60.0)
                    names = [e.name for e in obs.peek_events()]
                    out["update_spans"] = sum(n.startswith(obs.SPAN_UPDATE + "/") for n in names)
                    out["dispatch_spans"] = sum(n.startswith(obs.SPAN_DISPATCH + "/MetricCollection") for n in names)
                print(json.dumps(out), flush=True)
    finally:
        ex._KEEP_SHARE = keep
        ex._Dispatcher._capture = capture
        obs.set_telemetry(None)
        obs.set_tracing(None)
        shutil.rmtree(cache, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
