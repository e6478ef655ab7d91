"""The port's FID, KID, MiFID and Inception Score against the JAX package.

Both packages get the same numpy features through callable extractors (the
identity: the "images" are the features), so these tests hold the metrics'
arithmetic; the network is held in ``test_torch_inception.py``.

Tolerances. On the CPU both packages take FID's PSD square root by a float32
LAPACK ``eigh``; the JAX package then takes the trace term in float32, the
port in float64 (and forms FID's moments in float64), and covariances and
kernel matrices are float32 products summed in another order. On these
small, well-conditioned features values agree within rtol 1e-4 (FID, MiFID,
KID's mean and std) and 1e-5 (IS); integer counts and the IS permutation are
equal. ``_compute_fid`` is held to scipy's float64 ``sqrtm``: JAX within its
own test's 1e-3 (5e-3 rank-deficient), the port within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.image as jax_image
from torchmetrics_tpu.image.fid import _compute_fid as jax_compute_fid
from torchmetrics_tpu_torch import image
from torchmetrics_tpu_torch.image.fid import _compute_fid
from torchmetrics_tpu_torch.utils import prng

RTOL = 1e-4
IS_RTOL = 1e-5


def _identity(x):
    return x


def _features(seed, n, f, shift=0.0, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, f) * scale + shift).astype(np.float32)


def _run(port, ref, batches):
    """Feed both metrics ``(features, kwargs)`` batches and compute."""
    for x, kw in batches:
        port.update(torch.from_numpy(x), **kw)
        ref.update(jnp.asarray(x), **kw)
    return port.compute(), ref.compute()


def _assert_close(port, ref, rtol=RTOL):
    if isinstance(ref, tuple):
        for p, r in zip(port, ref):
            _assert_close(p, r, rtol)
        return
    np.testing.assert_allclose(float(port), float(ref), rtol=rtol, atol=1e-7)


def _real_fake(f=16, n=48):
    return [
        (_features(1, n, f), {"real": True}),
        (_features(2, n, f, shift=0.1, scale=1.2), {"real": False}),
        (_features(3, n // 2, f), {"real": True}),
        (_features(4, n // 2, f, shift=0.1, scale=1.2), {"real": False}),
    ]


@pytest.mark.parametrize("f,n", [(16, 48), (64, 40)], ids=["full_rank", "rank_deficient"])
def test_fid_matches_jax(f, n):
    port = image.FrechetInceptionDistance(feature_extractor=_identity, num_features=f, device="cpu")
    ref = jax_image.FrechetInceptionDistance(feature_extractor=_identity, num_features=f, executor=False)
    _assert_close(*_run(port, ref, _real_fake(f, n)))
    assert int(port.real_features_num_samples) == int(ref.real_features_num_samples) == n + n // 2
    assert port.real_features_num_samples.dtype == torch.int32


@pytest.mark.parametrize("kw", [{}, {"degree": 2, "coef": 0.5}, {"gamma": 0.3}], ids=["default", "degree2", "gamma"])
def test_kid_matches_jax(kw):
    port = image.KernelInceptionDistance(feature_extractor=_identity, subsets=6, subset_size=20, device="cpu", **kw)
    ref = jax_image.KernelInceptionDistance(feature_extractor=_identity, subsets=6, subset_size=20, executor=False, **kw)
    _assert_close(*_run(port, ref, _real_fake()))


@pytest.mark.parametrize("eps", [0.1, 0.9], ids=["penalty_one", "penalty_distance"])
def test_mifid_matches_jax(eps):
    port = image.MemorizationInformedFrechetInceptionDistance(feature_extractor=_identity, cosine_distance_eps=eps, device="cpu")
    ref = jax_image.MemorizationInformedFrechetInceptionDistance(feature_extractor=_identity, cosine_distance_eps=eps, executor=False)
    _assert_close(*_run(port, ref, _real_fake()))


@pytest.mark.parametrize("n,splits", [(50, 3), (100, 10), (7, 7)])
def test_inception_score_matches_jax(n, splits):
    logits = np.random.RandomState(n).randn(n, 10).astype(np.float32) * 3
    port = image.InceptionScore(feature_extractor=_identity, splits=splits, device="cpu")
    ref = jax_image.InceptionScore(feature_extractor=_identity, splits=splits, executor=False)
    _assert_close(*_run(port, ref, [(logits[: n // 2], {}), (logits[n // 2 :], {})]), IS_RTOL)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000, 1626, 1627, 10000])
def test_permutation_is_bit_equal_to_jax(n):
    np.testing.assert_array_equal(prng.permutation(42, n), np.asarray(jax.random.permutation(jax.random.PRNGKey(42), n)))


@pytest.mark.parametrize("seed", [0, 1, -1, 2**31 + 5, 2**40 + 3])
def test_split_and_bits_are_bit_equal_to_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == tuple(int(w) for w in np.asarray(key))
    assert prng.split(prng.prng_key(seed), 3) == [tuple(int(w) for w in k) for k in np.asarray(jax.random.split(key, 3))]
    np.testing.assert_array_equal(prng.random_bits(prng.prng_key(seed), 33), np.asarray(jax.random.bits(key, (33,))))


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient"])
def test_compute_fid_matches_scipy_sqrtm(case):
    """Both packages against scipy's float64 ``sqrtm`` FID: JAX within its own
    test's tolerance (float32 throughout), the port within 1e-5 (its trace
    term is float64 around the float32 root), so never further than JAX."""
    from scipy import linalg

    if case == "full_rank":
        rng = np.random.RandomState(5)
        f1, f2 = rng.randn(200, 8), rng.randn(200, 8) + 0.5
        jax_tol = 1e-3
    else:  # 24 samples of 96 features: rank 23
        rng = np.random.RandomState(7)
        f1, f2 = rng.randn(24, 96), rng.randn(24, 96) * 1.1 + 0.3
        jax_tol = 5e-3
    mu1, mu2 = f1.mean(0), f2.mean(0)
    s1, s2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
    want = ((mu1 - mu2) ** 2).sum() + np.trace(s1 + s2 - 2 * linalg.sqrtm(s1 @ s2).real)
    args = [torch.tensor(a, dtype=torch.float32) for a in (mu1, s1, mu2, s2)]
    got = _compute_fid(*args)
    ref = float(jax_compute_fid(*(jnp.asarray(a.numpy()) for a in args)))
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert abs(ref - want) / abs(want) < jax_tol
    assert abs(float(got) - want) / abs(want) < 1e-5
    assert abs(float(got) - want) <= abs(ref - want) + 1e-6 * abs(want)


@pytest.mark.parametrize("name", ["fid", "kid", "mifid"])
def test_reset_real_features_as_in_jax(name):
    ctor = {
        "fid": lambda pkg, **kw: pkg.FrechetInceptionDistance(feature_extractor=_identity, num_features=16, **kw),
        "kid": lambda pkg, **kw: pkg.KernelInceptionDistance(feature_extractor=_identity, subsets=3, subset_size=10, **kw),
        "mifid": lambda pkg, **kw: pkg.MemorizationInformedFrechetInceptionDistance(feature_extractor=_identity, **kw),
    }[name]
    for reset_real in (False, True):
        port = ctor(image, reset_real_features=reset_real, device="cpu")
        ref = ctor(jax_image, reset_real_features=reset_real, executor=False)
        batches = _real_fake()
        _run(port, ref, batches[:2])
        port.reset()
        ref.reset()
        if not reset_real:  # the real side survives: feed a new fake side and compare
            _assert_close(*_run(port, ref, batches[3:]))
        for key, value in ref.metric_state.items():
            got = port.metric_state[key]
            if isinstance(value, list):
                assert len(got) == len(value)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(value), rtol=1e-6)


def _message(err):
    """An error's text, with the network's module named alike in both packages."""
    return str(err.value).replace("built-in flax", "built-in").replace("torchmetrics_tpu_torch.", "torchmetrics_tpu.")


def test_errors_match_jax():
    def both(make, call=None):
        errors = []
        for pkg, kw in ((image, {"device": "cpu"}), (jax_image, {"executor": False})):
            with pytest.raises(Exception) as err:
                metric = make(pkg, kw)
                if call is not None:
                    call(metric, jnp.asarray if pkg is jax_image else torch.from_numpy)
            errors.append(err)
        assert errors[0].type is errors[1].type and _message(errors[0]) == _message(errors[1])

    def feed_and_compute(metric, to):
        for real in (True, False):
            metric.update(to(_features(0, 8, 4)), real=real)
        metric.compute()

    both(lambda pkg, kw: pkg.KernelInceptionDistance(feature_extractor=_identity, subset_size=9, **kw), feed_and_compute)

    def few_samples(metric, to):
        metric.update(to(_features(0, 3, 5)))
        metric.compute()

    both(lambda pkg, kw: pkg.InceptionScore(feature_extractor=_identity, splits=4, **kw), few_samples)
    for cls in ("FrechetInceptionDistance", "KernelInceptionDistance", "MemorizationInformedFrechetInceptionDistance", "InceptionScore"):
        both(lambda pkg, kw: getattr(pkg, cls)(**kw))  # no extractor, no weights: ModuleNotFoundError
    for bad in ({"subsets": 0}, {"subset_size": -1}, {"degree": 1.5}, {"gamma": 2}, {"coef": 1}, {"reset_real_features": 1}):
        both(lambda pkg, kw: pkg.KernelInceptionDistance(feature_extractor=_identity, **bad, **kw))
    for bad in ({"num_features": 0}, {"reset_real_features": "no"}, {"normalize": 1}, {"feature": 64, "num_features": 32}):
        both(lambda pkg, kw: pkg.FrechetInceptionDistance(feature_extractor=None if "feature" in bad else _identity, **bad, **kw))
    for bad in ({"cosine_distance_eps": 1.5}, {"cosine_distance_eps": 1}):
        both(lambda pkg, kw: pkg.MemorizationInformedFrechetInceptionDistance(feature_extractor=_identity, **bad, **kw))
    both(lambda pkg, kw: pkg.InceptionScore(feature_extractor=_identity, splits=0, **kw))


def test_missing_extractor_names_the_weights():
    with pytest.raises(ModuleNotFoundError, match="inception_params"):
        image.FrechetInceptionDistance(device="cpu")


@pytest.mark.parametrize("name", ["fid", "kid", "mifid", "is"])
def test_state_round_trip(name):
    make = {
        "fid": lambda: image.FrechetInceptionDistance(feature_extractor=_identity, num_features=16, device="cpu"),
        "kid": lambda: image.KernelInceptionDistance(feature_extractor=_identity, subsets=3, subset_size=10, device="cpu"),
        "mifid": lambda: image.MemorizationInformedFrechetInceptionDistance(feature_extractor=_identity, device="cpu"),
        "is": lambda: image.InceptionScore(feature_extractor=_identity, splits=2, device="cpu"),
    }[name]
    metric = make()
    for x, kw in _real_fake():
        metric.update(torch.from_numpy(x), **({} if name == "is" else kw))
    restored = make()
    restored.load_state(metric.state())
    want, got = metric.compute(), restored.compute()
    for w, g in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
        assert torch.equal(w, g)


def test_merged_fid_states_equal_one_fid_over_both():
    batches = _real_fake()
    whole = image.FrechetInceptionDistance(feature_extractor=_identity, num_features=16, device="cpu")
    parts = [image.FrechetInceptionDistance(feature_extractor=_identity, num_features=16, device="cpu") for _ in range(2)]
    for i, (x, kw) in enumerate(batches):
        whole.update(torch.from_numpy(x), **kw)
        parts[i // 2].update(torch.from_numpy(x), **kw)
    merged = parts[0].merge_states(parts[0].state(), parts[1].state())
    assert int(merged["real_features_num_samples"]) == int(whole.real_features_num_samples)
    torch.testing.assert_close(merged["fake_features_cov_sum"], whole.fake_features_cov_sum, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(parts[0].functional_compute(merged), whole.compute(), rtol=1e-5, atol=1e-6)


def test_normalize_feeds_the_extractor_uint8():
    seen = []

    def extractor(x):
        seen.append(x)
        return x.reshape(x.shape[0], -1)[:, :4].to(torch.float32)

    fid = image.FrechetInceptionDistance(feature_extractor=extractor, num_features=4, normalize=True, device="cpu")
    fid.update(torch.tensor([[[[0.0, 0.5], [0.999, 1.0]]]]).expand(2, 1, 2, 2), real=True)
    assert seen[0].dtype == torch.uint8 and seen[0][0].flatten().tolist() == [0, 127, 254, 255]


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    for cls in (image.FrechetInceptionDistance, image.KernelInceptionDistance, image.InceptionScore):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(feature_extractor=_identity)


def test_builtin_network_feeds_fid_as_a_callable_does():
    """``feature=64`` with weights builds the network; the same network as
    a callable gives the same FID."""
    from torchmetrics_tpu_torch.models import InceptionV3Features, inception_feature_extractor

    torch.manual_seed(0)
    state = InceptionV3Features().state_dict()
    imgs = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (8, 3, 32, 32)).astype(np.uint8))
    builtin = image.FrechetInceptionDistance(feature=64, inception_params=state, device="cpu")
    callable_ = image.FrechetInceptionDistance(
        feature_extractor=inception_feature_extractor(state, feature_dim=64, device="cpu"), num_features=64, device="cpu"
    )
    assert builtin.num_features == 64
    for metric in (builtin, callable_):
        metric.update(imgs[:4], real=True)
        metric.update(imgs[4:], real=False)
    assert torch.equal(builtin.compute(), callable_.compute())
