"""The port's LPIPS backbones, score, functional and class against the JAX
package's flax networks, on seeded parameters (``init_lpips_params``)
converted by ``params_from_jax``, at 64 x 64.

Tolerances: each backbone tap atol 1e-4 relative to the tap's largest
value (float32 convolutions summed in another order, through up to 13
layers); per-sample scores rtol 1e-4, atol 1e-6 (the normalised feature
differences are squared and averaged).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional as jax_functional
import torchmetrics_tpu.image as jax_image
import torchmetrics_tpu_torch.functional as functional
import torchmetrics_tpu_torch.image as image
from torchmetrics_tpu.models.lpips import _BACKBONES as JAX_BACKBONES
from torchmetrics_tpu.models.lpips import init_lpips_params
from torchmetrics_tpu.models.lpips import lpips_network as jax_lpips_network
from torchmetrics_tpu_torch.models.lpips import LPIPS_CHANNELS, LPIPSNetwork, lpips_network, params_from_jax

NETS = ("alex", "vgg", "squeeze")
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-6


def _tree(net_type, seed):
    return jax.tree_util.tree_map(np.asarray, init_lpips_params(net_type, jax.random.PRNGKey(seed)))


def _images(seed, n=3, size=64, low=-1.0):
    rng = np.random.RandomState(seed)
    img1 = rng.uniform(low, 1.0, (n, 3, size, size)).astype(np.float32)
    img2 = np.clip(img1 + 0.2 * rng.randn(*img1.shape), low, 1.0).astype(np.float32)
    return img1, img2


@pytest.mark.parametrize("net_type", NETS)
def test_feature_stack(net_type):
    tree = _tree(net_type, 1)
    net = lpips_network(net_type, tree, device="cpu")
    img, _ = _images(2)
    with torch.no_grad():
        port = net.net(torch.from_numpy(img))
    ref = JAX_BACKBONES[net_type]().apply({"params": tree["backbone"]}, jnp.asarray(img.transpose(0, 2, 3, 1)))
    assert [f.shape[1] for f in port] == list(LPIPS_CHANNELS[net_type])
    for p, r in zip(port, ref):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert p.shape == r.shape
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=1e-4 * max(np.abs(r).max(), 1e-6))


@pytest.mark.parametrize("net_type", NETS)
def test_score(net_type):
    tree = _tree(net_type, 3)
    img1, img2 = _images(4)
    port = lpips_network(net_type, tree, device="cpu")(torch.from_numpy(img1), torch.from_numpy(img2))
    ref = jax_lpips_network(net_type, init_lpips_params(net_type, jax.random.PRNGKey(3)))(jnp.asarray(img1), jnp.asarray(img2))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("net_type, reduction, normalize", [("alex", "mean", True), ("squeeze", "sum", False), ("vgg", "mean", False)])
def test_functional_and_class(net_type, reduction, normalize):
    tree = _tree(net_type, 5)
    port_net = lpips_network(net_type, tree, device="cpu")
    ref_net = jax_lpips_network(net_type, init_lpips_params(net_type, jax.random.PRNGKey(5)))
    low = 0.0 if normalize else -1.0
    batches = [_images(seed, n=2, low=low) for seed in (6, 7)]
    img1, img2 = batches[0]
    port = functional.learned_perceptual_image_patch_similarity(
        torch.from_numpy(img1), torch.from_numpy(img2), net=port_net, reduction=reduction, normalize=normalize
    )
    ref = jax_functional.learned_perceptual_image_patch_similarity(
        jnp.asarray(img1), jnp.asarray(img2), net=ref_net, reduction=reduction, normalize=normalize
    )
    np.testing.assert_allclose(float(port), float(ref), rtol=SCORE_RTOL, atol=SCORE_ATOL)

    m_port = image.LearnedPerceptualImagePatchSimilarity(
        net_type=net_type, params=tree, reduction=reduction, normalize=normalize, device="cpu"
    )
    m_ref = jax_image.LearnedPerceptualImagePatchSimilarity(net=ref_net, reduction=reduction, normalize=normalize)
    for a, b in batches:
        m_port.update(torch.from_numpy(a), torch.from_numpy(b))
        m_ref.update(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(m_port.compute()), float(m_ref.compute()), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("net_type", NETS)
def test_state_dict_names(net_type):
    """The converted tree is the network's whole state dict, in the
    reference network's names, and loads strictly."""
    state = params_from_jax(_tree(net_type, 8), net_type)
    network = LPIPSNetwork(net_type)
    assert list(state) == list(network.state_dict())
    network.load_state_dict(state)
    first = {"alex": "net.slice1.0.weight", "vgg": "net.slice1.0.weight", "squeeze": "net.slices.0.0.weight"}[net_type]
    assert first in state and "lin0.model.1.weight" in state and "scaling_layer.shift" in state


def test_params_from_jax_refuses_a_mismatch():
    tree = _tree("alex", 9)
    tree["lins"] = tree["lins"][:-1]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tree, "alex")


@pytest.mark.parametrize("img1, img2, normalize", [
    (np.zeros((2, 1, 8, 8)), np.zeros((2, 1, 8, 8)), False),
    (np.full((2, 3, 8, 8), 2.0), np.zeros((2, 3, 8, 8)), True),
    (np.full((2, 3, 8, 8), -1.5), np.zeros((2, 3, 8, 8)), False),
])
def test_invalid_inputs(img1, img2, normalize):
    for fn, cast, net in (
        (functional.learned_perceptual_image_patch_similarity, torch.tensor, lambda a, b: torch.zeros(a.shape[0])),
        (jax_functional.learned_perceptual_image_patch_similarity, jnp.asarray, lambda a, b: jnp.zeros(a.shape[0])),
    ):
        with pytest.raises(ValueError, match="normalized tensors"):
            fn(cast(img1), cast(img2), net=net, normalize=normalize)


def test_network_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lpips_network("alex")
