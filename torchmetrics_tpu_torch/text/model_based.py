"""The model-backed text metrics as classes: BERTScore and InfoLM.

Sentences are host data: the classes keep the raw strings in host lists and
run the model (a ``user_model`` hook, or a local ``transformers``
checkpoint) at compute, on the metric's device, where the matching and the
information measures run too. The lists take no part in a cross-process
sync: compute covers this process's sentences unless the caller gathers
them first.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.bert import bert_score
from torchmetrics_tpu_torch.functional.text.infolm import _InformationMeasure, infolm
from torchmetrics_tpu_torch.metric import Metric


class BERTScore(Metric):
    """BERTScore over every sentence pair seen, run at compute.

    Runs with any embedder through ``user_model`` or a local
    ``transformers`` checkpoint through ``model_name_or_path``. The raw
    sentences are host lists, cleared by ``reset``; they take no part in a
    cross-process sync.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import BERTScore
        >>> def user_model(sentences):  # a toy embedder: one-hot words
        ...     vocab = {w: i for i, w in enumerate(sorted({w for s in sentences for w in s.split()}))}
        ...     width = max(len(s.split()) for s in sentences)
        ...     emb = torch.zeros(len(sentences), width, len(vocab))
        ...     mask = torch.zeros(len(sentences), width, dtype=torch.bool)
        ...     for i, s in enumerate(sentences):
        ...         for j, w in enumerate(s.split()):
        ...             emb[i, j, vocab[w]] = 1.0
        ...             mask[i, j] = True
        ...     return emb, mask
        >>> bert = BERTScore(user_model=user_model, device="cpu")
        >>> bert.update(["the cat sat"], ["the cat sat"])
        >>> {k: round(float(v), 4) for k, v in bert.compute().items()}
        {'precision': 1.0, 'recall': 1.0, 'f1': 1.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_model: Optional[Callable[[List[str]], Tuple[Any, Any]]] = None,
        user_tokenizer: Optional[Callable[[str], List[str]]] = None,
        verbose: bool = False,
        idf: bool = False,
        max_length: int = 512,
        batch_size: int = 64,
        rescale_with_baseline: bool = False,
        baseline: Optional[torch.Tensor] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.model = model
        self.user_model = user_model
        self.user_tokenizer = user_tokenizer
        self.verbose = verbose
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline = baseline
        self._preds: List[str] = []
        self._target: List[str] = []

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        preds_l = [preds] if isinstance(preds, str) else list(preds)
        target_l = [target] if isinstance(target, str) else list(target)
        if len(preds_l) != len(target_l):
            raise ValueError(
                f"Number of predicted and reference sentences must match: {len(preds_l)} != {len(target_l)}"
            )
        self._preds.extend(preds_l)
        self._target.extend(target_l)

    def compute(self) -> Dict[str, torch.Tensor]:
        return bert_score(
            self._preds,
            self._target,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_model=self.user_model,
            user_tokenizer=self.user_tokenizer,
            verbose=self.verbose,
            idf=self.idf,
            max_length=self.max_length,
            batch_size=self.batch_size,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline=self.baseline,
            device=self.device,
        )

    def reset(self) -> None:
        super().reset()
        self._preds = []
        self._target = []


class InfoLM(Metric):
    """InfoLM over every sentence pair seen, run at compute.

    ``user_model`` maps a list of sentences to per-sentence masked-LM
    distributions. The raw sentences are host lists, cleared by ``reset``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import InfoLM
        >>> def mlm(sentences):  # a toy distribution over 4 tokens
        ...     return torch.tensor([[0.4, 0.3, 0.2, 0.1] if "cat" in s else [0.1, 0.2, 0.3, 0.4] for s in sentences])
        >>> ilm = InfoLM(information_measure="l1_distance", user_model=mlm, idf=False, device="cpu")
        >>> ilm.update(["the cat"], ["a dog"])
        >>> round(float(ilm.compute()), 4)
        1.8079
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        model_name_or_path: str = "bert-base-uncased",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        max_length: Optional[int] = None,
        user_model: Optional[Callable[[List[str]], Any]] = None,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        # validate the measure and its parameters eagerly
        _InformationMeasure(information_measure, alpha, beta)
        self.model_name_or_path = model_name_or_path
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.max_length = max_length
        self.user_model = user_model
        self.return_sentence_level_score = return_sentence_level_score
        self._preds: List[str] = []
        self._target: List[str] = []

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        preds_l = [preds] if isinstance(preds, str) else list(preds)
        target_l = [target] if isinstance(target, str) else list(target)
        if len(preds_l) != len(target_l):
            raise ValueError(
                f"Number of predicted and reference sentences must match: {len(preds_l)} != {len(target_l)}"
            )
        self._preds.extend(preds_l)
        self._target.extend(target_l)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        return infolm(
            self._preds,
            self._target,
            model_name_or_path=self.model_name_or_path,
            temperature=self.temperature,
            information_measure=self.information_measure,
            idf=self.idf,
            alpha=self.alpha,
            beta=self.beta,
            max_length=self.max_length,
            user_model=self.user_model,
            return_sentence_level_score=self.return_sentence_level_score,
            device=self.device,
        )

    def reset(self) -> None:
        super().reset()
        self._preds = []
        self._target = []
