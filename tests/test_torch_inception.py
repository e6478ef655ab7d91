"""The port's InceptionV3 against the JAX package's flax network.

Parameters are drawn from a numpy seed over the shapes of
``jax.eval_shape(InceptionV3Features().init, ...)``: He-scaled conv and fc
kernels (so activations stay O(1) through the depth), BatchNorm scales in
[0.8, 1.2], running variances in [0.5, 1.5], shifts and means N(0, 0.1²). The
same tree feeds the flax modules and, through ``params_from_jax``, the port.

Tolerances. Both run float32 convolutions that sum in another order (XLA's
and oneDNN's), and BatchNorm is applied as written in flax and folded in
PyTorch. The largest differences seen are 2e-6 of max |ref| per tap: held to
2e-5 of max |ref| for a block, 5e-5 for the whole network (26 layers deep).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.models.inception as jax_inception
from torchmetrics_tpu_torch.models import inception, params_from_jax

BLOCK_TOL = 2e-5
NET_TOL = 5e-5
TAPS = (64, 192, 768, 2048, "logits_unbiased", "logits")


def _leaf(path, shape, rng):
    name = "/".join(str(getattr(p, "key", p)) for p in path)
    if name.endswith("kernel"):
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name.endswith("var"):
        return rng.uniform(0.5, 1.5, shape)
    if name.endswith("scale"):
        return rng.uniform(0.8, 1.2, shape)
    return rng.randn(*shape) * 0.1


@pytest.fixture(scope="module")
def tree():
    abstract = jax.eval_shape(
        jax_inception.InceptionV3Features().init, jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3), jnp.float32)
    )
    rng = np.random.RandomState(2015)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(p, s.shape, rng).astype(np.float32),
        {"params": abstract["params"], "batch_stats": abstract["batch_stats"]},
    )


@pytest.fixture(scope="module")
def network(tree):
    net = inception.InceptionV3Features()
    net.load_state_dict(params_from_jax(tree))
    return net


def _close(port, ref, tol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("in_size,out_size", [(64, 299), (32, 299), (80, 299), (299, 299), (500, 299), (7, 13)])
def test_resize_matrix_is_bit_equal(in_size, out_size):
    np.testing.assert_array_equal(
        inception._tf1_resize_matrix(in_size, out_size), jax_inception._tf1_resize_matrix(in_size, out_size)
    )


def test_resize_matches_jax():
    x = np.random.RandomState(0).rand(2, 3, 32, 48).astype(np.float32)
    _close(inception.tf1_bilinear_resize(torch.from_numpy(x)).numpy(), jax_inception.tf1_bilinear_resize(jnp.asarray(x)), 1e-6)


BLOCKS = {
    "Mixed_5b": (jax_inception.InceptionA(32), 192),
    "Mixed_6a": (jax_inception.InceptionB(), 288),
    "Mixed_6b": (jax_inception.InceptionC(128), 768),
    "Mixed_7a": (jax_inception.InceptionD(), 768),
    "Mixed_7b": (jax_inception.InceptionE(pool="avg"), 1280),
    "Mixed_7c": (jax_inception.InceptionE(pool="max"), 2048),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, tree, network):
    """Each block at its real channel widths on a 2 x 9 x 9 input (odd, so
    the stride-2 branches and the pools meet a ragged edge)."""
    module, channels = BLOCKS[name]
    x = np.random.RandomState(len(name) + channels).randn(2, channels, 9, 9).astype(np.float32)
    variables = {"params": tree["params"][name], "batch_stats": tree["batch_stats"][name]}
    ref = module.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        port = getattr(network, name)(torch.from_numpy(x))
    _close(port.numpy().transpose(0, 2, 3, 1), ref, BLOCK_TOL)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1234).randint(0, 256, (2, 3, 64, 64)).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_taps(tree, images):
    x = jax_inception.tf1_bilinear_resize((jnp.asarray(images).astype(jnp.float32) - 128.0) / 128.0, 299)

    @jax.jit
    def run(params, x):
        feats = jax_inception.InceptionV3Features().apply(params, jnp.transpose(x, (0, 2, 3, 1)))
        return tuple(feats[k] for k in TAPS)

    return dict(zip(TAPS, run(tree, x)))


def test_whole_network_matches_jax_at_all_taps(network, images, jax_taps):
    x = inception.tf1_bilinear_resize((torch.from_numpy(images).float() - 128.0) / 128.0, 299)
    with torch.no_grad():
        port = network(x)
    assert tuple(port[64].shape) == (2, 64, 73, 73) and tuple(port[768].shape) == (2, 768, 17, 17)
    for tap in TAPS:
        got = port[tap].numpy()
        _close(got.transpose(0, 2, 3, 1) if got.ndim == 4 else got, jax_taps[tap], NET_TOL)


@pytest.mark.parametrize("tap", TAPS)
def test_extractor_matches_jax_taps(tree, images, jax_taps, tap):
    """The extractor (scale, resize, network, spatial mean) against the JAX
    taps averaged as the JAX extractor averages them."""
    port = inception.inception_feature_extractor(tree, feature_dim=tap, device="cpu")(torch.from_numpy(images))
    ref = jax_taps[tap]
    _close(port.numpy(), ref.mean(axis=(1, 2)) if ref.ndim == 4 else ref, NET_TOL)


def test_extractor_default_device_needs_a_gpu():
    """Like every entry point of the port, the extractor runs on the current
    CUDA device unless told otherwise, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inception.inception_feature_extractor(None, feature_dim=64)


def test_state_dict_names_are_torch_fidelitys(network):
    names = set(network.state_dict())
    assert {
        "Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.conv.weight", "Mixed_5b.branch1x1.bn.running_var",
        "Mixed_7c.branch3x3dbl_3b.bn.bias", "fc.weight", "fc.bias",
    } <= names
    assert tuple(network.state_dict()["fc.weight"].shape) == (1008, 2048)
    assert sum(n.endswith("conv.weight") for n in names) == 94


def test_params_round_trip_through_the_jax_converter(tree):
    """JAX tree -> port state dict -> JAX's torch-fidelity converter gives
    the same tree back, leaf for leaf."""
    state = {k: v.numpy() for k, v in params_from_jax(tree).items()}
    back = jax_inception.params_from_torch_fidelity_state_dict(state)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def test_a_state_dict_loads_without_conversion(tree, network):
    """A torch-fidelity-named state dict (here the port's own) loads with
    ``load_state_dict``, also without the ``num_batches_tracked`` counters."""
    state = {k: v for k, v in network.state_dict().items() if not k.endswith("num_batches_tracked")}
    other = inception.InceptionV3Features()
    other.load_state_dict(state)
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(), network.state_dict().values()))


def _with(tree, path, value=None, drop=False):
    params = {k: dict(v) for k, v in tree.items()}
    node = params
    for part in path[:-1]:
        node[part] = dict(node[part])
        node = node[part]
    if drop:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return params


@pytest.mark.parametrize(
    "edit,match",
    [
        (lambda t: _with(t, ("params", "Mixed_5b", "extra"), np.zeros(3, np.float32)), "Unrecognised"),
        (lambda t: _with(t, ("params", "fc_bias"), drop=True), "missing"),
        (lambda t: _with(t, ("batch_stats", "Mixed_6a"), drop=True), "missing"),
        (lambda t: _with(t, ("params", "fc_bias"), np.zeros(10, np.float32)), "Shape mismatch"),
        (lambda t: _with(t, ("params", "Conv2d_1a_3x3", "conv", "kernel"), np.zeros((3, 3, 3, 33), np.float32)), "Shape mismatch"),
    ],
    ids=["unknown", "missing_leaf", "missing_block", "bias_shape", "kernel_shape"],
)
def test_params_from_jax_refuses_bad_trees(tree, edit, match):
    with pytest.raises(ValueError, match=match):
        params_from_jax(edit(tree))


@pytest.mark.parametrize("feature", [100, "pool", 2049])
def test_invalid_feature_raises_as_in_jax(feature):
    with pytest.raises(ValueError) as ref:
        jax_inception.resolve_feature_argument("FID", feature, None, None)
    with pytest.raises(ValueError) as port:
        inception.resolve_feature_argument("FID", feature, None, None)
    assert str(port.value) == str(ref.value)


def test_invalid_arguments_raise_as_in_jax():
    def both(fn_name, *args, **kw):
        errors = []
        for module in (jax_inception, inception):
            with pytest.raises(Exception) as err:
                getattr(module, fn_name)(*args, **kw)
            errors.append(err)
        assert errors[0].type is errors[1].type
        return errors

    both("resolve_feature_argument", "FID", 2048, lambda x: x, None)  # feature and extractor both
    missing = both("resolve_feature_argument", "FID", 2048, None, None)  # no weights
    assert missing[1].type is ModuleNotFoundError and "inception_params" in str(missing[1].value)
    both("inception_feature_extractor", None, feature_dim=100)


def test_network_stays_in_eval_mode(network):
    network.train()
    assert not network.training and not network.Mixed_5b.branch1x1.bn.training
