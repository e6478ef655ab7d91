"""CLIPScore and CLIP-IQA on the user's embedding functions.

The metrics take the joint embedder as hooks, as the JAX package's do, so
any CLIP (or any image-text embedder) drives them:

    embedding_fn(images, texts) -> (img_features (N, F), txt_features (N, F))

for CLIPScore, and for CLIP-IQA:

    image_embedding_fn(images) -> (N, F)
    text_embedding_fn(list_of_prompts) -> (P, F)

The hooks' outputs go to the metric's device (a functional's: the images')
with ``torch.as_tensor``. Pretrained CLIP weights are not fetched: building
a metric without its hooks raises with guidance.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.compute import full_float32

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def _features(x, device: torch.device) -> torch.Tensor:
    """A hook's output on ``device``; float64 as float32, the JAX package's
    32-bit default."""
    x = torch.as_tensor(x, device=device)
    return x.to(torch.float32) if x.dtype == torch.float64 else x


def _clip_score_update(images, text, embedding_fn: Callable, device: Optional[torch.device] = None):
    """Per-sample ``100 * cosine(image, caption)`` scores and their count."""
    if not isinstance(images, (list, tuple)):
        images = torch.as_tensor(images)
        if images.ndim == 3:
            images = images[None]
        images = list(images)
    else:
        images = [torch.as_tensor(i) for i in images]
    if not all(i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )
    stacked = torch.stack(images)
    device = stacked.device if device is None else device
    img_features, txt_features = embedding_fn(stacked, text)
    img_features = _l2_normalize(_features(img_features, device))
    txt_features = _l2_normalize(_features(txt_features, device))
    score = 100 * torch.sum(img_features * txt_features, dim=-1)
    return score, len(text)


def clip_score(images, text, embedding_fn: Callable) -> torch.Tensor:
    """Functional CLIPScore: the mean ``100 * cosine(image, caption)``,
    floored at 0.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import clip_score
        >>> def embed(images, texts):
        ...     img_f = torch.stack([img.mean(dim=(1, 2)) for img in images])
        ...     txt_f = torch.tensor([[len(t), t.count('a'), 1.0] for t in texts])
        ...     return img_f, txt_f
        >>> imgs = (torch.arange(2 * 3 * 8 * 8).reshape(2, 3, 8, 8) % 255) / 255.0
        >>> texts = ["a photo of a cat", "a photo of a dog"]
        >>> round(float(clip_score(imgs, texts, embedding_fn=embed)), 4)
        62.4327
    """
    score, n_samples = _clip_score_update(images, text, embedding_fn)
    return torch.clamp(score.sum() / n_samples, min=0.0)


class CLIPScore(Metric):
    """Mean CLIP image-caption alignment score.

    ``embedding_fn(images, texts) -> (img_features, txt_features)`` supplies
    the joint embedder.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.multimodal import CLIPScore
        >>> def embed(images, texts):  # a toy joint embedder
        ...     img_f = torch.stack([img.mean(dim=(1, 2)) for img in images])
        ...     txt_f = torch.tensor([[len(t), t.count("a"), 1.0] for t in texts])
        ...     return img_f, txt_f
        >>> score = CLIPScore(embedding_fn=embed, device="cpu")
        >>> imgs = (torch.arange(2 * 3 * 8 * 8).reshape(2, 3, 8, 8) % 255) / 255.0
        >>> score.update(imgs, ["a photo of a cat", "a photo of a dog"])
        >>> round(float(score.compute()), 4)
        62.4327
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    def __init__(self, embedding_fn: Optional[Callable] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if embedding_fn is None:
            raise ModuleNotFoundError(
                "CLIPScore requires an `embedding_fn(images, texts) -> (img_features, txt_features)` callable."
                " Pretrained CLIP weights are not fetched; pass a CLIP model's embedding function or any joint"
                " embedder."
            )
        self.embedding_fn = embedding_fn
        self.add_state("score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, images, text) -> None:
        score, n_samples = _clip_score_update(images, text, self.embedding_fn, self.device)
        self.score = self.score + score.sum(0)
        self.n_samples = self.n_samples + n_samples

    def compute(self) -> torch.Tensor:
        return torch.clamp(self.score / self.n_samples, min=0.0)


def _clip_iqa_format_prompts(prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",)):
    """Expand prompt keywords and custom (positive, negative) pairs."""
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
    prompts_names: List[str] = []
    prompts_list: List[str] = []
    count = 0
    for p in prompts:
        if not isinstance(p, (str, tuple)):
            raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {list(_PROMPTS.keys())} if not custom tuple prompts, got {p}."
                )
            prompts_names.append(p)
            prompts_list.extend(_PROMPTS[p])
        else:
            if len(p) != 2:
                raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
            prompts_names.append(f"user_defined_{count}")
            prompts_list.extend(p)
            count += 1
    return prompts_list, prompts_names


def clip_image_quality_assessment(
    images: torch.Tensor,
    image_embedding_fn: Callable,
    text_embedding_fn: Callable,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    data_range: float = 1.0,
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """CLIP-IQA: per prompt pair, ``softmax(100 * [sim_pos, sim_neg])[0]``
    is the image's probability of the positive prompt (one tensor for one
    pair, else a dict by prompt name). The similarities are one full-float32
    product."""
    prompts_list, prompts_names = _clip_iqa_format_prompts(prompts)
    images = torch.as_tensor(images) / float(data_range)
    img_features = _l2_normalize(_features(image_embedding_fn(images), images.device))
    anchors = _l2_normalize(_features(text_embedding_fn(prompts_list), images.device))
    with full_float32():
        logits = 100 * img_features @ anchors.T
    probs = torch.softmax(logits.reshape(logits.shape[0], -1, 2), dim=-1)[:, :, 0]
    if len(prompts_names) == 1:
        return probs.squeeze()
    return {name: probs[:, i] for i, name in enumerate(prompts_names)}


class CLIPImageQualityAssessment(Metric):
    """Prompt-anchored no-reference image quality; ``compute`` returns the
    per-image probabilities.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment
        >>> iqa = CLIPImageQualityAssessment(
        ...     image_embedding_fn=lambda imgs: imgs.mean(dim=(2, 3)),
        ...     text_embedding_fn=lambda texts: torch.tensor(
        ...         [[len(t), t.count("o"), 1.0] for t in texts]), device="cpu")
        >>> imgs = (torch.arange(2 * 3 * 8 * 8).reshape(2, 3, 8, 8) % 255) / 255.0
        >>> iqa.update(imgs)
        >>> [round(float(x), 4) for x in iqa.compute()]
        [0.9965, 0.1062]
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        image_embedding_fn: Optional[Callable] = None,
        text_embedding_fn: Optional[Callable] = None,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        data_range: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if image_embedding_fn is None or text_embedding_fn is None:
            raise ModuleNotFoundError(
                "CLIPImageQualityAssessment requires `image_embedding_fn(images) -> (N, F)` and"
                " `text_embedding_fn(prompts) -> (P, F)` callables; pretrained CLIP weights are not fetched."
            )
        self.image_embedding_fn = image_embedding_fn
        self.text_embedding_fn = text_embedding_fn
        self.prompts_list, self.prompts_names = _clip_iqa_format_prompts(prompts)
        self._prompts_arg = prompts
        self.data_range = data_range
        self.add_state("probs_list", default=[], dist_reduce_fx="cat")

    def update(self, images: torch.Tensor) -> None:
        probs = clip_image_quality_assessment(
            images, self.image_embedding_fn, self.text_embedding_fn, self._prompts_arg, self.data_range
        )
        if isinstance(probs, dict):
            probs = torch.stack([probs[n] for n in self.prompts_names], dim=1)
        self.probs_list.append(torch.atleast_2d(probs.reshape(-1, len(self.prompts_names))))

    def compute(self) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        probs = torch.cat(self.probs_list, dim=0)
        if len(self.prompts_names) == 1:
            return probs[:, 0].squeeze()
        return {name: probs[:, i] for i, name in enumerate(self.prompts_names)}
