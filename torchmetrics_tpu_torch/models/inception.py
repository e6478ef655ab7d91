"""InceptionV3 feature extractor for FID / KID / IS / MiFID, as ``nn.Module`` s.

The network of torch-fidelity's ``FeatureExtractorInceptionV3`` (the
TF-1.x-compatible InceptionV3 that FID is defined on), with its quirks, as
the JAX package's flax port (``torchmetrics_tpu/models/inception.py``) has
them:

- TF-1.x "legacy" bilinear resize to 299 x 299 (``src = dst * in / out``, no
  half-pixel offset), as two products with resize matrices;
- uint8 [0, 255] input scaled to [-1, 1] as ``(x - 128) / 128``;
- ``BasicConv2d`` = bias-free conv + ``BatchNorm2d(eps=1e-3)`` in eval mode +
  ReLU;
- average pools that do not count the padding in blocks A, C and E1, and a
  3 x 3 / 1 max pool with same padding in the last block's pool branch;
- feature taps at 64 (first pool), 192 (second pool), 768 (Mixed_6e) and 2048
  (global average pool), and the 1008-class head: ``logits_unbiased`` (before
  the bias) and ``logits``.

Layout is NCHW throughout. Submodules and parameters carry the names of
torch-fidelity's state dict (``Mixed_5b.branch1x1.conv.weight``,
``...bn.running_var``, ``fc.weight``, ``fc.bias``), so its checkpoint loads
with ``load_state_dict`` and no conversion. :func:`params_from_jax` turns the
JAX package's parameter tree into that state dict. Weights are not bundled.

Precision: the convolutions run in whatever mode the caller's PyTorch is set
to; on a GPU cuDNN uses TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False. Nothing here changes that flag.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.models.serialization import flatten_tree

VALID_FEATURE_DIMS = (64, 192, 768, 2048)
# string taps: the 1008-class TF-inception classifier head (torch-fidelity's
# 'logits_unbiased' = pre-bias fc output, what InceptionScore consumes)
VALID_FEATURE_KEYS = VALID_FEATURE_DIMS + ("logits", "logits_unbiased")
NUM_LOGITS = 1008


@functools.lru_cache(maxsize=32)
def _tf1_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Row matrix for TF-1.x legacy bilinear resize (align_corners=False, no
    half-pixel offset): src = dst * (in/out)."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        src = i * scale
        lo = int(math.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        mat[i, lo] += 1.0 - frac
        mat[i, hi] += frac
    mat.setflags(write=False)
    return mat


def tf1_bilinear_resize(x: torch.Tensor, size: int = 299) -> torch.Tensor:
    """Resize NCHW images with TF-1.x legacy bilinear semantics: ``Wh x Ww^T``."""
    h, w = x.shape[2], x.shape[3]
    if h == size and w == size:
        return x
    wh = torch.tensor(_tf1_resize_matrix(h, size), device=x.device)
    ww = torch.tensor(_tf1_resize_matrix(w, size), device=x.device)
    return torch.matmul(torch.matmul(wh, x), ww.T)


class BasicConv2d(nn.Module):
    """Bias-free conv + BN(eps=1e-3, affine) + ReLU, inference mode."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride=1, padding=0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3/1 average pool with SAME extent but count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nopad(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_nopad(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(nn.Module):
    """Final inception block; ``pool="avg"`` for E1, ``"max"`` for the FID E2 quirk."""

    def __init__(self, in_channels: int, pool: str = "avg") -> None:
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        # the max pool's implicit -inf padding is reduce_window's -inf init
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max" else _avg_pool_nopad(x)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """The FID InceptionV3 on NCHW input already scaled to [-1, 1]; returns
    the 64 / 192 / 768 maps, the pooled 2048 features, ``logits_unbiased``
    and ``logits``. Always in eval mode (BatchNorm reads its running stats)."""

    def __init__(self) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.fc = nn.Linear(2048, NUM_LOGITS)
        self.eval()

    def train(self, mode: bool = True) -> "InceptionV3Features":
        """Stays in eval mode, as torch-fidelity's extractor does."""
        return super().train(False)

    def forward(self, x: torch.Tensor) -> Dict[Union[int, str], torch.Tensor]:
        feats: Dict[Union[int, str], torch.Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        feats[64] = x
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        feats[192] = x
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        feats[768] = x
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))  # global average pool -> (N, 2048)
        feats[2048] = pooled
        logits_unbiased = F.linear(pooled, self.fc.weight)
        feats["logits_unbiased"] = logits_unbiased
        feats["logits"] = logits_unbiased + self.fc.bias
        return feats


def _state_template() -> Dict[str, tuple]:
    """Names and shapes of the network's state dict, without materialising it."""
    with torch.device("meta"):
        net = InceptionV3Features()
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3 parameter tree (``{"params": ...,
    "batch_stats": ...}``, numpy arrays or anything ``np.asarray`` takes) as a
    state dict of :class:`InceptionV3Features`, in torch-fidelity's names:

    - ``params/<block>/conv/kernel`` (HWIO) -> ``<block>.conv.weight`` (OIHW);
    - ``params/<block>/bn/{scale,bias}`` -> ``<block>.bn.{weight,bias}``;
    - ``batch_stats/<block>/bn/{mean,var}`` -> ``<block>.bn.running_{mean,var}``;
    - ``params/fc/kernel`` (2048, 1008) -> ``fc.weight`` (1008, 2048);
    - ``params/fc_bias`` -> ``fc.bias``.

    Every leaf is checked against the network's own names and shapes; an
    unknown, missing or mis-shaped entry raises ``ValueError``. BatchNorm's
    ``num_batches_tracked`` counters come out as 0.
    """
    bn_leaves = {("params", "scale"): "weight", ("params", "bias"): "bias",
                 ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}
    state: Dict[str, torch.Tensor] = {}
    for key, value in flatten_tree(dict(tree)).items():
        parts = key.split("/")
        collection, path, leaf = parts[0], parts[1:-1], parts[-1]
        value = np.asarray(value, dtype=np.float32)
        if collection == "params" and path == ["fc"] and leaf == "kernel":
            name, value = "fc.weight", value.T
        elif collection == "params" and not path and leaf == "fc_bias":
            name = "fc.bias"
        elif collection == "params" and path[-1:] == ["conv"] and leaf == "kernel":
            name = ".".join(path) + ".weight"
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value
        elif path[-1:] == ["bn"] and (collection, leaf) in bn_leaves:
            name = ".".join(path) + "." + bn_leaves[(collection, leaf)]
        else:
            raise ValueError(f"Unrecognised InceptionV3 parameter: {key!r}")
        state[name] = torch.from_numpy(np.ascontiguousarray(value))

    template = _state_template()
    for name in template:
        if name.endswith("num_batches_tracked"):
            state[name] = torch.tensor(0, dtype=torch.int64)
    missing = sorted(set(template) - set(state))
    extra = sorted(set(state) - set(template))
    if missing or extra:
        raise ValueError(f"InceptionV3 parameters: missing {missing}, unexpected {extra}")
    for name, shape in template.items():
        if tuple(state[name].shape) != shape:
            raise ValueError(f"Shape mismatch at {name!r}: expected {shape}, got {tuple(state[name].shape)}")
    return {name: state[name] for name in template}


def _as_state_dict(params: Mapping[str, Any]) -> Mapping[str, Any]:
    """A state dict as given, or a JAX parameter tree converted."""
    if "params" in params and isinstance(params["params"], Mapping):
        return params_from_jax(params)
    return params


class InceptionFeatureExtractor(nn.Module):
    """``imgs -> (N, F)``: NCHW images in [0, 255] (uint8 or float), scaled
    as ``(x - 128) / 128``, TF-1.x-bilinear resized to 299 x 299, through
    :class:`InceptionV3Features`; a spatial tap is averaged over its map.
    ``network`` is the module, so a caller can hook its outputs."""

    def __init__(self, network: InceptionV3Features, feature_dim: Union[int, str]) -> None:
        super().__init__()
        self.network = network
        self.feature_dim = feature_dim

    @torch.no_grad()
    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        x = (imgs.to(torch.float32) - 128.0) / 128.0
        x = tf1_bilinear_resize(x, 299)
        f = self.network(x)[self.feature_dim]
        return f.mean(dim=(2, 3)) if f.ndim == 4 else f


def inception_feature_extractor(
    params: Optional[Mapping[str, Any]] = None,
    feature_dim: Union[int, str] = 2048,
    device: Union[str, torch.device, None] = None,
) -> InceptionFeatureExtractor:
    """Build the ``imgs -> (N, F)`` callable FID/KID/IS/MiFID consume.

    ``params``: a state dict in torch-fidelity's names (a real checkpoint
    loads as it is) or the JAX package's parameter tree; ``None`` keeps
    PyTorch's random initialisation (shapes only, for testing).
    ``feature_dim``: one of 64/192/768/2048 (feature taps) or
    ``"logits"``/``"logits_unbiased"`` (the 1008-class head InceptionScore
    uses). ``device``: where the network runs; ``None`` is the current CUDA
    device, and raises where there is none (pass ``"cpu"`` to run it there).
    """
    if feature_dim not in VALID_FEATURE_KEYS:
        raise ValueError(f"Argument `feature_dim` must be one of {VALID_FEATURE_KEYS}, got {feature_dim}")
    device = resolve_device(device)
    network = InceptionV3Features()
    if params is not None:
        network.load_state_dict(_as_state_dict(params))
    return InceptionFeatureExtractor(network.to(device), feature_dim)


def resolve_inception_extractor(
    metric_name: str,
    feature_extractor,
    inception_params: Optional[Mapping[str, Any]],
    feature_dim: Union[int, str] = 2048,
    device: Union[str, torch.device, None] = None,
):
    """Shared fallback for FID/KID/IS/MiFID: callable wins; otherwise build the
    built-in InceptionV3 from ``inception_params``; otherwise raise."""
    if feature_extractor is not None:
        return feature_extractor
    if inception_params is None:
        raise ModuleNotFoundError(
            f"{metric_name} requires either a `feature_extractor` callable mapping images to"
            " (N, F) features, or `inception_params` for the built-in InceptionV3"
            " (torchmetrics_tpu_torch.models.inception). Bundled pretrained weights are not"
            " available in this environment."
        )
    return inception_feature_extractor(inception_params, feature_dim=feature_dim, device=device)


def resolve_feature_argument(
    metric_name: str,
    feature,
    feature_extractor,
    inception_params: Optional[Mapping[str, Any]],
    default_dim: Union[int, str] = 2048,
    device: Union[str, torch.device, None] = None,
):
    """The ``feature`` argument of FID/KID/IS/MiFID: an integer or string
    selects an InceptionV3 tap (and needs ``inception_params``), a callable is
    the extractor. Returns ``(extractor, feature_dim)``, where
    ``feature_dim`` is None when a callable was supplied (its output width is
    the caller's contract)."""
    if feature is not None and feature_extractor is not None:
        raise ValueError(f"{metric_name}: pass either `feature` or `feature_extractor`, not both")
    if feature is not None and callable(feature):
        return feature, None
    feature_dim = default_dim if feature is None else feature
    if feature_dim not in VALID_FEATURE_KEYS:
        raise ValueError(
            f"Integer input to argument `feature` must be one of {list(VALID_FEATURE_DIMS)},"
            f" string input must be 'logits' or 'logits_unbiased', but got {feature_dim}"
        )
    extractor = resolve_inception_extractor(
        metric_name, feature_extractor, inception_params, feature_dim=feature_dim, device=device
    )
    if feature_extractor is not None:
        return extractor, None
    return extractor, feature_dim
