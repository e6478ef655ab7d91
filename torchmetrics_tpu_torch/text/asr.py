"""The ASR error rates as classes: WER, CER, MER, WIL and WIP.

Two or three float32 sum states on the metric's device, summed across
processes. An update counts on the host (one native Levenshtein call) and
adds Python floats to the states, so no update copies a tensor to the device.
"""
from __future__ import annotations

from typing import Any, List, Union

import torch

from torchmetrics_tpu_torch.functional.text.asr import (
    _cer_compute,
    _cer_update,
    _mer_compute,
    _mer_update,
    _wer_compute,
    _wer_update,
    _wil_compute,
    _wip_compute,
    _word_info_update,
)
from torchmetrics_tpu_torch.metric import Metric


class WordErrorRate(Metric):
    """Word error rate, accumulated over updates.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordErrorRate
        >>> wer = WordErrorRate(device="cpu")
        >>> wer.update(["this is the answer", "hello duck"],
        ...            ["this was the answer", "hello world"])
        >>> round(float(wer.compute()), 4)
        0.3333
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _wer_update(preds, target)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _wer_compute(self.errors, self.total)


class CharErrorRate(Metric):
    """Character error rate, accumulated over updates.

    Example:
        >>> from torchmetrics_tpu_torch.text import CharErrorRate
        >>> cer = CharErrorRate(device="cpu")
        >>> cer.update(["this is the answer", "hello duck"],
        ...            ["this was the answer", "hello world"])
        >>> round(float(cer.compute()), 4)
        0.2333
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _cer_update(preds, target)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _cer_compute(self.errors, self.total)


class MatchErrorRate(Metric):
    """Match error rate, accumulated over updates.

    Example:
        >>> from torchmetrics_tpu_torch.text import MatchErrorRate
        >>> mer = MatchErrorRate(device="cpu")
        >>> mer.update(["this is the answer", "hello duck"],
        ...            ["this was the answer", "hello world"])
        >>> round(float(mer.compute()), 4)
        0.3333
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _mer_update(preds, target)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _mer_compute(self.errors, self.total)


class WordInfoLost(Metric):
    """Word information lost, accumulated over updates.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoLost
        >>> wil = WordInfoLost(device="cpu")
        >>> wil.update(["this is the answer", "hello duck"],
        ...            ["this was the answer", "hello world"])
        >>> round(float(wil.compute()), 4)
        0.5556
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _word_info_update(preds, target)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> torch.Tensor:
        return _wil_compute(self.errors, self.target_total, self.preds_total)


class WordInfoPreserved(Metric):
    """Word information preserved, accumulated over updates.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoPreserved
        >>> wip = WordInfoPreserved(device="cpu")
        >>> wip.update(["this is the answer", "hello duck"],
        ...            ["this was the answer", "hello world"])
        >>> round(float(wip.compute()), 4)
        0.4444
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _word_info_update(preds, target)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> torch.Tensor:
        return _wip_compute(self.errors, self.target_total, self.preds_total)
