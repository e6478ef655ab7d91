"""LearnedPerceptualImagePatchSimilarity: running sums of the per-sample
scores and of the sample count (``dist_reduce_fx="sum"``)."""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch

from torchmetrics_tpu_torch.functional.image.lpips import _lpips_compute, _lpips_update
from torchmetrics_tpu_torch.metric import Metric


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS with a pluggable scoring network.

    Args:
        net: callable ``(img1, img2) -> (N,)`` scores of NCHW inputs in
            [-1, 1]; overrides ``net_type``/``params`` when given.
        net_type: ``"alex"``, ``"vgg"`` or ``"squeeze"``: the built-in
            network (``models.lpips.lpips_network``) on the metric's device.
        params: its state dict, or the JAX package's parameter tree.
        reduction: ``"mean"`` or ``"sum"`` over the samples seen.
        normalize: inputs in [0, 1] instead of [-1, 1].

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
        >>> img1 = (torch.arange(4 * 3 * 8 * 8).reshape(4, 3, 8, 8) % 255) / 255.0
        >>> lpips = LearnedPerceptualImagePatchSimilarity(
        ...     net=lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3)), device="cpu")
        >>> lpips.update(img1, img1 * 0.7)
        >>> round(float(lpips.compute()), 4)
        0.0297
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        net: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        net_type: str = "alex",
        params: Optional[Mapping[str, Any]] = None,
        reduction: str = "mean",
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_net_type = ("vgg", "alex", "squeeze")
        if net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        if net is None:
            if params is None:
                raise ModuleNotFoundError(
                    "LearnedPerceptualImagePatchSimilarity requires either a `net` callable or `params` for the"
                    " built-in network; pretrained backbones are not bundled. Build params with the JAX package's"
                    " init_lpips_params, or pass a reference LPIPS state dict."
                )
            from torchmetrics_tpu_torch.models.lpips import lpips_network

            net = lpips_network(net_type, params, device=self.device)
        self.net = net
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be an bool but got {normalize}")
        self.normalize = normalize
        self.add_state("sum_scores", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: torch.Tensor, img2: torch.Tensor) -> None:
        loss, total = _lpips_update(torch.as_tensor(img1), torch.as_tensor(img2), self.net, self.normalize)
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _lpips_compute(self.sum_scores, self.total, self.reduction)
