"""The three LPIPS backbones (AlexNet, VGG16, SqueezeNet 1.1 feature stacks)
and their lin heads, as ``nn.Module`` s in NCHW.

Submodules carry the names of the reference LPIPS network's state dict
(``net.slice1.0.weight`` for AlexNet and VGG16, ``net.slices.0.0.weight``
and ``net.slices.1.3.squeeze.weight`` for SqueezeNet, ``lin0.model.1.weight``
for the heads, ``scaling_layer.shift``), so such a checkpoint loads with
``load_state_dict`` and no conversion. :func:`params_from_jax` turns the JAX
package's parameter tree (``init_lpips_params``) into that state dict.
Weights are not bundled.

Precision: :class:`LPIPSNetwork` runs its convolutions in full float32
(TF32 off), as the JAX package has no TF32 default.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utils.compute import full_float32

LPIPS_CHANNELS: Dict[str, Tuple[int, ...]] = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}

# ImageNet-statistics scaling of [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _sequential(layers: Mapping[int, nn.Module]) -> nn.Sequential:
    """A slice of a torchvision ``features`` stack, each layer under its index there."""
    seq = nn.Sequential()
    for index, layer in layers.items():
        seq.add_module(str(index), layer)
    return seq


class AlexNetFeatures(nn.Module):
    """torchvision ``alexnet().features`` cut after each ReLU: five taps."""

    def __init__(self) -> None:
        super().__init__()
        self.slice1 = _sequential({0: nn.Conv2d(3, 64, 11, stride=4, padding=2), 1: nn.ReLU()})
        self.slice2 = _sequential({2: nn.MaxPool2d(3, 2), 3: nn.Conv2d(64, 192, 5, padding=2), 4: nn.ReLU()})
        self.slice3 = _sequential({5: nn.MaxPool2d(3, 2), 6: nn.Conv2d(192, 384, 3, padding=1), 7: nn.ReLU()})
        self.slice4 = _sequential({8: nn.Conv2d(384, 256, 3, padding=1), 9: nn.ReLU()})
        self.slice5 = _sequential({10: nn.Conv2d(256, 256, 3, padding=1), 11: nn.ReLU()})

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for k in range(1, 6):
            x = getattr(self, f"slice{k}")(x)
            feats.append(x)
        return feats


class VGG16Features(nn.Module):
    """torchvision ``vgg16().features`` cut at relu1_2, 2_2, 3_3, 4_3 and 5_3."""

    def __init__(self) -> None:
        super().__init__()
        index, in_ch = 0, 3
        for k, (ch, n_convs) in enumerate([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)], start=1):
            layers: Dict[int, nn.Module] = {}
            if k > 1:
                layers[index] = nn.MaxPool2d(2, 2)
                index += 1
            for _ in range(n_convs):
                layers[index] = nn.Conv2d(in_ch, ch, 3, padding=1)
                layers[index + 1] = nn.ReLU()
                index, in_ch = index + 2, ch
            setattr(self, f"slice{k}", _sequential(layers))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for k in range(1, 6):
            x = getattr(self, f"slice{k}")(x)
            feats.append(x)
        return feats


class Fire(nn.Module):
    """SqueezeNet's fire module: a 1 x 1 squeeze, then 1 x 1 and 3 x 3
    expands side by side, concatenated."""

    def __init__(self, in_ch: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.squeeze_activation = nn.ReLU()
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand1x1_activation = nn.ReLU()
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)
        self.expand3x3_activation = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.squeeze_activation(self.squeeze(x))
        return torch.cat([self.expand1x1_activation(self.expand1x1(s)), self.expand3x3_activation(self.expand3x3(s))], 1)


class SqueezeNetFeatures(nn.Module):
    """torchvision ``squeezenet1_1().features`` in LPIPS's seven slices
    (ceil-mode max pools)."""

    def __init__(self) -> None:
        super().__init__()

        def pool() -> nn.MaxPool2d:
            return nn.MaxPool2d(3, 2, ceil_mode=True)

        self.slices = nn.ModuleList([
            _sequential({0: nn.Conv2d(3, 64, 3, stride=2), 1: nn.ReLU()}),
            _sequential({2: pool(), 3: Fire(64, 16, 64), 4: Fire(128, 16, 64)}),
            _sequential({5: pool(), 6: Fire(128, 32, 128), 7: Fire(256, 32, 128)}),
            _sequential({8: pool(), 9: Fire(256, 48, 192)}),
            _sequential({10: Fire(384, 48, 192)}),
            _sequential({11: Fire(384, 64, 256)}),
            _sequential({12: Fire(512, 64, 256)}),
        ])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for piece in self.slices:
            x = piece(x)
            feats.append(x)
        return feats


_BACKBONES = {"alex": AlexNetFeatures, "vgg": VGG16Features, "squeeze": SqueezeNetFeatures}


class NetLinLayer(nn.Module):
    """A lin head: dropout (identity in eval) and a bias-free 1 x 1
    convolution to one channel, i.e. a weighted channel sum."""

    def __init__(self, chn_in: int) -> None:
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(chn_in, 1, 1, bias=False))


class _ScalingLayer(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None])


class LPIPSNetwork(nn.Module):
    """``(img1, img2) -> (N,)`` LPIPS scores of NCHW images in [-1, 1]:
    a backbone (``net``), the lin heads (``lin0`` ...) and the scaling
    layer, in the reference network's names. Always in eval mode."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        if net_type not in _BACKBONES:
            raise ValueError(f"Argument `net_type` must be one of {list(_BACKBONES)}, got {net_type}")
        self.net_type = net_type
        self.scaling_layer = _ScalingLayer()
        self.net = _BACKBONES[net_type]()
        for k, ch in enumerate(LPIPS_CHANNELS[net_type]):
            setattr(self, f"lin{k}", NetLinLayer(ch))
        self.lins = nn.ModuleList([getattr(self, f"lin{k}") for k in range(len(LPIPS_CHANNELS[net_type]))])
        self.eval()
        self.requires_grad_(False)

    def lin_weights(self) -> List[torch.Tensor]:
        return [lin.model[1].weight.reshape(-1) for lin in self.lins]

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        from torchmetrics_tpu_torch.functional.image.lpips import _lpips_score

        with full_float32():
            return _lpips_score(img1, img2, self.net, self.lin_weights())


# the torchvision ``features`` index of each flax conv, per backbone
_TORCH_CONV_INDEX = {
    "alex": {"conv1": ("slice1", 0), "conv2": ("slice2", 3), "conv3": ("slice3", 6),
             "conv4": ("slice4", 8), "conv5": ("slice5", 10)},
    "vgg": {"conv1": ("slice1", 0), "conv2": ("slice1", 2), "conv3": ("slice2", 5),
            "conv4": ("slice2", 7), "conv5": ("slice3", 10), "conv6": ("slice3", 12),
            "conv7": ("slice3", 14), "conv8": ("slice4", 17), "conv9": ("slice4", 19),
            "conv10": ("slice4", 21), "conv11": ("slice5", 24), "conv12": ("slice5", 26),
            "conv13": ("slice5", 28)},
}
_SQUEEZE_FIRES = {"fire3": 3, "fire4": 4, "fire6": 6, "fire7": 7, "fire9": 9, "fire10": 10, "fire11": 11, "fire12": 12}
_SQUEEZE_SLICE_OF = {0: 0, 3: 1, 4: 1, 6: 2, 7: 2, 9: 3, 10: 4, 11: 5, 12: 6}


def _conv_leaves(prefix: str, leaf: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A flax conv's ``kernel`` (HWIO) and ``bias`` as ``weight`` (OIHW) and ``bias``."""
    kernel = np.asarray(leaf["kernel"], dtype=np.float32).transpose(3, 2, 0, 1)
    return {f"{prefix}.weight": kernel, f"{prefix}.bias": np.asarray(leaf["bias"], dtype=np.float32)}


def params_from_jax(tree: Mapping[str, Any], net_type: str = "alex") -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS parameter tree (``{"backbone": flax params,
    "lins": [(C_k,) arrays]}``, numpy arrays or anything ``np.asarray``
    takes) as a state dict of :class:`LPIPSNetwork` ``(net_type)``. Every
    entry is checked against the network's names and shapes; a missing,
    unknown or mis-shaped one raises ``ValueError``."""
    if net_type not in _BACKBONES:
        raise ValueError(f"Argument `net_type` must be one of {list(_BACKBONES)}, got {net_type}")
    backbone = tree["backbone"]
    leaves: Dict[str, np.ndarray] = {}
    if net_type in _TORCH_CONV_INDEX:
        for ours, (slc, idx) in _TORCH_CONV_INDEX[net_type].items():
            leaves.update(_conv_leaves(f"net.{slc}.{idx}", backbone[ours]))
    else:
        leaves.update(_conv_leaves("net.slices.0.0", backbone["conv1"]))
        for ours, idx in _SQUEEZE_FIRES.items():
            for part in ("squeeze", "expand1x1", "expand3x3"):
                leaves.update(_conv_leaves(f"net.slices.{_SQUEEZE_SLICE_OF[idx]}.{idx}.{part}", backbone[ours][part]))
    lins = list(tree["lins"])
    for k, w in enumerate(lins):
        w = np.asarray(w, dtype=np.float32).reshape(1, -1, 1, 1)
        leaves[f"lin{k}.model.1.weight"] = leaves[f"lins.{k}.model.1.weight"] = w
    leaves["scaling_layer.shift"] = np.asarray(_SHIFT, dtype=np.float32).reshape(1, 3, 1, 1)
    leaves["scaling_layer.scale"] = np.asarray(_SCALE, dtype=np.float32).reshape(1, 3, 1, 1)

    template = {k: tuple(v.shape) for k, v in LPIPSNetwork(net_type).state_dict().items()}
    missing, extra = sorted(set(template) - set(leaves)), sorted(set(leaves) - set(template))
    if missing or extra:
        raise ValueError(f"LPIPS {net_type} parameters: missing {missing}, unexpected {extra}")
    for name, shape in template.items():
        if leaves[name].shape != shape:
            raise ValueError(f"Shape mismatch at {name!r}: expected {shape}, got {leaves[name].shape}")
    return {name: torch.from_numpy(np.array(leaves[name], dtype=np.float32)) for name in template}


def _as_state_dict(params: Mapping[str, Any], net_type: str) -> Mapping[str, Any]:
    """A state dict as given, or a JAX parameter tree converted."""
    if "backbone" in params and "lins" in params:
        return params_from_jax(params, net_type)
    return params


def lpips_network(
    net_type: str = "alex",
    params: Optional[Mapping[str, Any]] = None,
    device: Union[str, torch.device, None] = None,
) -> LPIPSNetwork:
    """Build the ``net(img1, img2) -> (N,)`` LPIPS scorer on ``device``.

    ``params``: a state dict in the reference network's names (a real
    checkpoint loads as it is) or the JAX package's parameter tree; ``None``
    keeps PyTorch's random initialisation (shapes only, for testing).
    ``device``: ``None`` is the current CUDA device, and raises where there
    is none (pass ``"cpu"`` to run it there).
    """
    device = resolve_device(device)
    network = LPIPSNetwork(net_type)
    if params is not None:
        network.load_state_dict(_as_state_dict(params, net_type))
    return network.to(device)

