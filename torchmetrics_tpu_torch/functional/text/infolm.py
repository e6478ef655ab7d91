"""InfoLM: information measures between masked-LM token distributions.

A masked language model gives each sentence a distribution over the
vocabulary (an IDF- or length-weighted average of its per-position masked
predictions); the metric is an information measure between the candidate's
and the reference's (Colombo et al., 2021).

Getting the distributions is the model's job: ``user_model`` maps a list of
sentences to an ``[N, vocab]`` matrix, as numpy (copied to ``device``) or as
a torch tensor already on ``device`` (used in place). Without a hook, a
``transformers`` masked LM runs on ``device`` from local weights only. The
temperature, the normalisation and the measure run on ``device``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _on_device, _text_device

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)


class _InformationMeasure:
    """The nine information measures, vectorised over sentence pairs:
    ``__call__(preds_distribution [N, V], target_distribution [N, V]) -> [N]``,
    NaN and inf replaced as ``torch.nan_to_num`` replaces them.

    ``beta_divergence`` sets ``alpha`` to 1.0 on the measure object itself
    (the reference's behaviour), so a later call of the same object sees it.
    """

    def __init__(self, information_measure: str, alpha: Optional[float] = None, beta: Optional[float] = None) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Argument `information_measure` expected one of {_ALLOWED_INFORMATION_MEASURE}, got {information_measure}"
            )
        self.information_measure = information_measure
        needs_alpha = ("alpha_divergence", "ab_divergence", "renyi_divergence")
        if information_measure in needs_alpha and not isinstance(alpha, float):
            raise ValueError(f"Parameter `alpha` is expected to be defined for {information_measure}.")
        if information_measure in ("beta_divergence", "ab_divergence") and not isinstance(beta, float):
            raise ValueError(f"Parameter `beta` is expected to be defined for {information_measure}.")
        if information_measure == "alpha_divergence" and (not isinstance(alpha, float) or alpha in (0, 1)):
            raise ValueError(
                f"Parameter `alpha` is expected to be float differened from 0 and 1 for {information_measure}."
            )
        if information_measure == "beta_divergence" and (not isinstance(beta, float) or beta in (0, -1)):
            raise ValueError(
                f"Parameter `beta` is expected to be float differened from 0 and -1 for {information_measure}."
            )
        if information_measure == "ab_divergence" and (
            alpha is None or beta is None or 0 in (alpha, beta, alpha + beta)
        ):
            raise ValueError(
                f"Parameters `alpha`, `beta` and their sum are expected to be differened from 0 for {information_measure}."
            )
        if information_measure == "renyi_divergence" and (not isinstance(alpha, float) or alpha == 1):
            raise ValueError(f"Parameter `alpha` is expected to be float differened from 1 for {information_measure}.")
        self.alpha = alpha or 0.0
        self.beta = beta or 0.0

    def __call__(self, preds_distribution: torch.Tensor, target_distribution: torch.Tensor) -> torch.Tensor:
        fn = getattr(self, f"_calculate_{self.information_measure}")
        return torch.nan_to_num(fn(preds_distribution, target_distribution))

    @staticmethod
    def _calculate_kl_divergence(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return torch.sum(t * torch.log(p / t), dim=-1)

    def _calculate_alpha_divergence(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        alpha_denom = self.alpha * (self.alpha - 1)
        return (1 - torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / alpha_denom

    def _calculate_ab_divergence(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        a = torch.log(torch.sum(t ** (self.beta + self.alpha), dim=-1)) / (self.beta * (self.beta + self.alpha))
        b = torch.log(torch.sum(p ** (self.beta + self.alpha), dim=-1)) / (self.alpha * (self.beta + self.alpha))
        c = torch.log(torch.sum(t**self.alpha * p**self.beta, dim=-1)) / (self.alpha * self.beta)
        return a + b - c

    def _calculate_beta_divergence(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        self.alpha = 1.0
        return self._calculate_ab_divergence(p, t)

    def _calculate_renyi_divergence(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return torch.log(torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / (self.alpha - 1)

    @staticmethod
    def _calculate_l1_distance(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.sum((t - p) ** 2, dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return torch.amax(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sum(torch.sqrt(p * t), dim=-1), 0.0, 1.0))


def _default_transformers_mlm_distribution(
    model_name_or_path: str, max_length: int, idf: bool, device: torch.device
) -> Callable[[List[str]], torch.Tensor]:
    """A ``transformers`` masked LM on ``device``, from local weights only:
    each non-special position masked in turn, its predicted distribution
    weighted by the IDF of the token it covers (over this call's sentences)
    or equally, and averaged."""
    try:
        from transformers import AutoModelForMaskedLM, AutoTokenizer
    except ImportError as err:  # pragma: no cover
        raise ModuleNotFoundError(
            "`infolm` needs either a `user_model` callable or the `transformers` package with local weights."
        ) from err
    tok = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
    model = AutoModelForMaskedLM.from_pretrained(model_name_or_path, local_files_only=True).to(device)
    model.eval()
    special = set(tok.all_special_ids)

    def distribution(sentences: List[str]) -> torch.Tensor:
        encodings = [tok(s, truncation=True, max_length=max_length)["input_ids"] for s in sentences]
        if idf:
            df: dict = {}
            for ids in encodings:
                for t in set(ids):
                    df[t] = df.get(t, 0) + 1
            idf_map = {t: math.log((len(sentences) + 1) / (cnt + 1)) for t, cnt in df.items()}
        out_rows = []
        with torch.no_grad():
            for ids in encodings:
                positions = [pos for pos, t in enumerate(ids) if t not in special]
                if not positions:
                    vocab = model.config.vocab_size
                    out_rows.append(torch.full((vocab,), 1.0 / vocab, device=device))
                    continue
                masked = torch.tensor(ids, device=device).repeat(len(positions), 1)
                rows = torch.arange(len(positions), device=device)
                cols = torch.tensor(positions, device=device)
                masked[rows, cols] = tok.mask_token_id
                probs = torch.softmax(model(masked).logits[rows, cols], dim=-1)
                w = torch.tensor([idf_map[ids[p]] if idf else 1.0 for p in positions], device=device)[:, None]
                out_rows.append((probs * w).sum(0) / w.sum())
        return torch.stack(out_rows)

    return distribution


def _normalised(distribution: torch.Tensor, temperature: float) -> torch.Tensor:
    """The distribution sharpened by ``1 / temperature`` and renormalised."""
    sharpened = distribution ** (1.0 / temperature)
    return sharpened / torch.sum(sharpened, dim=-1, keepdim=True)


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: str = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    max_length: Optional[int] = None,
    user_model: Optional[Callable[[List[str]], Any]] = None,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """InfoLM: the mean over sentence pairs of ``information_measure``
    between the temperature-sharpened distributions, with the sentence
    scores when ``return_sentence_level_score``; on ``device`` (default: the
    current CUDA device).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import infolm
        >>> def mlm(sentences):  # a toy distribution over 4 tokens
        ...     return torch.tensor([[0.4, 0.3, 0.2, 0.1] if "cat" in s else [0.1, 0.2, 0.3, 0.4] for s in sentences])
        >>> round(float(infolm(["the cat"], ["a dog"], information_measure="l1_distance", user_model=mlm, device="cpu")), 4)
        1.8079
    """
    device = _text_device(device)
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if len(preds_l) != len(target_l):
        raise ValueError(f"Number of predicted and reference sentences must match: {len(preds_l)} != {len(target_l)}")
    measure = _InformationMeasure(information_measure, alpha, beta)
    if user_model is None:
        user_model = _default_transformers_mlm_distribution(model_name_or_path, max_length or 512, idf, device)
    preds_distribution = _normalised(_on_device(user_model(preds_l), device, "distributions"), temperature)
    target_distribution = _normalised(_on_device(user_model(target_l), device, "distributions"), temperature)
    sentence_scores = measure(preds_distribution, target_distribution)
    corpus = sentence_scores.mean()
    if return_sentence_level_score:
        return corpus, sentence_scores
    return corpus
