"""Networks behind the model-based metrics: the FID InceptionV3 for FID, KID,
IS and MiFID, and the LPIPS backbones for LPIPS and PPL. Weights are not bundled; a metric takes a state dict, the JAX
package's parameter tree, or its own feature-extractor callable."""
from torchmetrics_tpu_torch.models.inception import (
    InceptionFeatureExtractor,
    InceptionV3Features,
    inception_feature_extractor,
    params_from_jax,
)
from torchmetrics_tpu_torch.models.lpips import LPIPSNetwork, lpips_network
from torchmetrics_tpu_torch.models.serialization import flatten_tree, load_npz_tree, unflatten_tree

__all__ = [
    "InceptionFeatureExtractor",
    "InceptionV3Features",
    "LPIPSNetwork",
    "flatten_tree",
    "inception_feature_extractor",
    "load_npz_tree",
    "lpips_network",
    "params_from_jax",
    "unflatten_tree",
]
