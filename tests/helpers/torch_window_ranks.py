"""The rank side of the windowed two-rank gloo sync test
(``tests/test_torch_windows.py``), kept apart so that each spawned rank
imports only torch, numpy and the port."""
import numpy as np
import torch

import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu_torch.aggregation import SumMetric
from torchmetrics_tpu_torch.windows import WindowedMetric


class LastPeak(ttm.Metric):
    """A ``max`` state that an update REPLACES, defaulting to 0: a dead slot's
    default is no identity for it (a negative live peak must win the fold)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("peak", torch.tensor(0.0), dist_reduce_fx="max")

    def update(self, x):
        self.peak = x.max()

    def compute(self):
        return self.peak


def rank_windowed(rank, world):
    """Rank ``rank``'s windowed sum and last-peak metrics over its own
    batches and clock (rank 1 one window ahead); their local states and
    the synced compute."""
    rng = np.random.RandomState(40 + rank)
    out = {}
    for name, inner in (("sum", SumMetric(nan_strategy="disable", device="cpu")), ("peak", LastPeak(device="cpu"))):
        win = WindowedMetric(inner, window=3, lateness=1)
        batches = [rng.randint(-9, 9, 3).astype(np.float32) for _ in range(5)]
        for i, b in enumerate(batches):
            win.update(torch.from_numpy(b))
            if i in (1, 3) or (rank and i == 4):
                win.advance()
        out[name] = {
            "local": {f: v.detach().cpu().numpy().copy() for f, v in win.metric_state.items()},
            "synced": win.compute().detach().cpu().numpy().copy(),
        }
    return out
