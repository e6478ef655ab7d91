"""The port's regression functionals and classes against the JAX package.

The same seeded numpy inputs go through the JAX function or class (eager,
``executor=False``) and through the port on the CPU. Tolerances:

- values: rtol 1e-5, atol 1e-6 (float32 sums in another order);
- Kendall's pair counts and the critical success index's counts: bit for
  bit, as integers (the port counts in int64, tiles of the pair matrix
  included; JAX densely, in int32);
- Kendall's tau and p-value: rtol 1e-5 (the port forms them from the
  counts in float64, JAX in float32);
- Spearman's float64 ranks past 2**23 samples (forced here at a small
  limit): within 1e-12 of scipy's ``spearmanr``.

Pearson's count is an exact int64 in the port (float32 in JAX); below
2**24 both give the same moments. The synced Pearson compute is held to
JAX's Chan merge in ``tests/test_torch_sync.py``.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as functional
import torchmetrics_tpu_torch.regression as regression
from torchmetrics_tpu_torch.functional.regression import rank_based
from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs

RTOL, ATOL = 1e-5, 1e-6
N = 40


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu.functional as jax_functional
    import torchmetrics_tpu.regression as jax_regression

    return jnp, jax_functional, jax_regression


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    if isinstance(ref, (tuple, list)):
        assert isinstance(port, (tuple, list)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, rtol, atol)
        return
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=atol, equal_nan=True)


# ------------------------------------------------------------------ the data


def _data(seed, shape=(N,), kind="real"):
    """``preds`` and ``target`` of one kind: ``real`` (correlated normals),
    ``positive`` (in [0.5, 3]), ``ties`` (rounded to one decimal) or
    ``dist`` (rows of positive weights)."""
    rng = np.random.RandomState(seed)
    if kind == "positive":
        target = rng.uniform(0.5, 3.0, shape)
        preds = target * rng.uniform(0.7, 1.3, shape)
    elif kind == "dist":
        target = rng.uniform(0.05, 1.0, shape)
        preds = rng.uniform(0.05, 1.0, shape)
    else:
        preds = rng.randn(*shape)
        target = 0.8 * preds + 0.4 * rng.randn(*shape) + 0.2
        if kind == "ties":
            preds, target = np.round(preds, 1), np.round(target, 1)
    return preds.astype(np.float32), target.astype(np.float32)


def _batches(seed, shape=(N,), kind="real", n=3):
    return [_data(seed + i, shape, kind) for i in range(n)]


# ------------------------------------------------------------ functionals

FUNCTIONAL_CASES = [
    ("mean_absolute_error", {}, (N,), "real"),
    ("mean_absolute_error", {}, (N, 3), "real"),
    ("mean_squared_error", {}, (N,), "real"),
    ("mean_squared_error", {"squared": False}, (N,), "real"),
    ("mean_squared_error", {"num_outputs": 3}, (N, 3), "real"),
    ("mean_squared_error", {"num_outputs": 3, "squared": False}, (N, 3), "real"),
    ("mean_squared_log_error", {}, (N,), "positive"),
    ("mean_absolute_percentage_error", {}, (N,), "real"),
    ("symmetric_mean_absolute_percentage_error", {}, (N,), "real"),
    ("weighted_mean_absolute_percentage_error", {}, (N,), "real"),
    ("relative_squared_error", {}, (N,), "real"),
    ("relative_squared_error", {"squared": False}, (N, 3), "real"),
    ("log_cosh_error", {}, (N,), "real"),
    ("log_cosh_error", {}, (N, 3), "real"),
    ("minkowski_distance", {"p": 1}, (N,), "real"),
    ("minkowski_distance", {"p": 2.5}, (N, 3), "real"),
    ("tweedie_deviance_score", {"power": 0.0}, (N,), "real"),
    ("tweedie_deviance_score", {"power": 1.0}, (N,), "positive"),
    ("tweedie_deviance_score", {"power": 1.5}, (N,), "positive"),
    ("tweedie_deviance_score", {"power": 2.0}, (N,), "positive"),
    ("tweedie_deviance_score", {"power": 3.0}, (N,), "positive"),
    ("tweedie_deviance_score", {"power": -1.0}, (N,), "positive"),
    ("critical_success_index", {"threshold": 0.3}, (N,), "real"),
    ("critical_success_index", {"threshold": 0.3, "keep_sequence_dim": 0}, (5, 4, 6), "real"),
    ("critical_success_index", {"threshold": 0.3, "keep_sequence_dim": 2}, (5, 4, 6), "real"),
    ("explained_variance", {}, (N,), "real"),
    ("explained_variance", {"multioutput": "raw_values"}, (N, 3), "real"),
    ("explained_variance", {"multioutput": "variance_weighted"}, (N, 3), "real"),
    ("r2_score", {}, (N,), "real"),
    ("r2_score", {"adjusted": 2}, (N,), "real"),
    ("r2_score", {"multioutput": "raw_values"}, (N, 3), "real"),
    ("r2_score", {"multioutput": "variance_weighted", "adjusted": 1}, (N, 3), "real"),
    ("pearson_corrcoef", {}, (N,), "real"),
    ("pearson_corrcoef", {}, (N, 3), "real"),
    ("concordance_corrcoef", {}, (N,), "real"),
    ("concordance_corrcoef", {}, (N, 3), "real"),
    ("spearman_corrcoef", {}, (N,), "ties"),
    ("spearman_corrcoef", {}, (N, 3), "ties"),
    ("cosine_similarity", {}, (N, 3), "real"),
    ("cosine_similarity", {"reduction": "mean"}, (N, 3), "real"),
    ("cosine_similarity", {"reduction": "none"}, (N, 3), "real"),
    ("kl_divergence", {}, (N, 4), "dist"),
    ("kl_divergence", {"reduction": "sum"}, (N, 4), "dist"),
    ("kl_divergence", {"reduction": None}, (N, 4), "dist"),
    ("kl_divergence", {"log_prob": True, "reduction": "mean"}, (N, 4), "log"),
]


def _ids(case):
    name, kwargs, shape, _ = case
    return f"{name}-{'-'.join(f'{k}={v}' for k, v in kwargs.items())}-{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("case", FUNCTIONAL_CASES, ids=_ids)
def test_functional_matches_jax(case):
    jnp, jax_functional, _ = _jax()
    name, kwargs, shape, kind = case
    if kind == "log":
        p, q = (np.log(a / a.sum(-1, keepdims=True)).astype(np.float32) for a in _data(1, shape, "dist"))
    else:
        p, q = _data(1, shape, kind)
    port = getattr(functional, name)(torch.from_numpy(p), torch.from_numpy(q), **kwargs)
    ref = getattr(jax_functional, name)(jnp.asarray(p), jnp.asarray(q), **kwargs)
    assert port.dtype == torch.float32
    _close(port, ref)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
@pytest.mark.parametrize("t_test,alternative", [(False, None), (True, "two-sided"), (True, "greater"), (True, "less")])
@pytest.mark.parametrize("shape", [(N,), (N, 2)], ids=["1d", "2d"])
def test_kendall_matches_jax(variant, t_test, alternative, shape):
    jnp, jax_functional, _ = _jax()
    p, q = _data(2, shape, "ties")
    kwargs = {"variant": variant, "t_test": t_test, "alternative": alternative}
    port = functional.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(q), **kwargs)
    ref = jax_functional.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(q), **kwargs)
    _close(port, ref)


def _jax_dense_counts(x, y):
    """The JAX package's dense pair counts (its ``_kendall_tau_update``
    expressions): concordant, discordant, tied in x, tied in y."""
    import jax.numpy as jnp

    x, y = jnp.asarray(x), jnp.asarray(y)
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    iu = jnp.triu_indices(x.shape[0], k=1)
    sp = (jnp.sign(dx) * jnp.sign(dy))[iu]
    return np.asarray([(sp > 0).sum(), (sp < 0).sum(), (dx[iu] == 0).sum(), (dy[iu] == 0).sum()])


@pytest.mark.parametrize("tile_pairs", [None, 7, 64, 37 * 5], ids=["one_tile", "rows_of_1", "rows_of_1_wide", "rows_of_5"])
@pytest.mark.parametrize("n", [1, 2, 37])
def test_kendall_tiled_counts_equal_jax_dense_bit_for_bit(tile_pairs, n):
    p, q = _data(3, (n,), "ties")
    p[::7] = np.nan  # NaN pairs count nowhere in both forms
    q[n // 2] = p[n // 2] = 0.5
    counts = rank_based._kendall_pair_counts(torch.from_numpy(p), torch.from_numpy(q), tile_pairs=tile_pairs)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy(), _jax_dense_counts(p, q).astype(np.int64))


def test_kendall_tiles_split_rows_at_the_module_default(monkeypatch):
    """The tile size the class path uses (the module constant) cuts several
    tiles here, and tau is unchanged."""
    p, q = _data(4, (N,), "ties")
    whole = functional.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(q))
    monkeypatch.setattr(rank_based, "_KENDALL_TILE_PAIRS", 3 * N)
    tiled = functional.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(q))
    assert torch.equal(whole, tiled)


def test_spearman_ranks_go_float64_past_the_float32_limit(monkeypatch):
    """Past the limit (2**23 samples; lowered to 16 here) ranks and moments
    are float64: the value is scipy's within 1e-12 before the final
    rounding to float32."""
    from scipy.stats import spearmanr

    p, q = _data(5, (N,), "ties")
    monkeypatch.setattr(rank_based, "_FLOAT32_RANK_LIMIT", 16)
    got = functional.spearman_corrcoef(torch.from_numpy(p), torch.from_numpy(q))
    want = spearmanr(p.astype(np.float64), q.astype(np.float64)).statistic
    assert got.dtype == torch.float32
    assert abs(float(got) - np.float32(want)) <= np.spacing(np.float32(want)) + 1e-12


def test_rank_average_equals_scipy():
    from scipy.stats import rankdata

    p, _ = _data(6, (N,), "ties")
    got = rank_based._rank_data_average(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), rankdata(p, method="average").astype(np.float32))


def test_critical_success_index_counts_equal_jax_bit_for_bit():
    jnp = _jax()[0]
    from torchmetrics_tpu.functional.regression.basic import _critical_success_index_update as jax_update

    from torchmetrics_tpu_torch.functional.regression.basic import _critical_success_index_update

    p, q = _data(7, (5, 4, 6))
    for keep in (None, 0, 1, 2):
        port = _critical_success_index_update(torch.from_numpy(p), torch.from_numpy(q), 0.3, keep)
        ref = jax_update(jnp.asarray(p), jnp.asarray(q), 0.3, keep)
        for a, b in zip(port, ref):
            assert a.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


# ------------------------------------------------------------------ classes

CLASS_CASES = [
    ("MeanAbsoluteError", {}, (N,), "real"),
    ("MeanSquaredError", {}, (N,), "real"),
    ("MeanSquaredError", {"squared": False}, (N,), "real"),
    ("MeanSquaredError", {"num_outputs": 3}, (N, 3), "real"),
    ("MeanSquaredLogError", {}, (N,), "positive"),
    ("MeanAbsolutePercentageError", {}, (N,), "real"),
    ("SymmetricMeanAbsolutePercentageError", {}, (N,), "real"),
    ("WeightedMeanAbsolutePercentageError", {}, (N,), "real"),
    ("RelativeSquaredError", {}, (N,), "real"),
    ("RelativeSquaredError", {"num_outputs": 3, "squared": False}, (N, 3), "real"),
    ("LogCoshError", {}, (N,), "real"),
    ("LogCoshError", {"num_outputs": 3}, (N, 3), "real"),
    ("MinkowskiDistance", {"p": 3}, (N,), "real"),
    ("TweedieDevianceScore", {"power": 1.5}, (N,), "positive"),
    ("TweedieDevianceScore", {"power": 0.0}, (N,), "real"),
    ("CriticalSuccessIndex", {"threshold": 0.3}, (N,), "real"),
    ("CriticalSuccessIndex", {"threshold": 0.3, "keep_sequence_dim": 0}, (5, 4, 6), "real"),
    ("CriticalSuccessIndex", {"threshold": 0.3, "keep_sequence_dim": 1}, (5, 4, 6), "real"),
    ("PearsonCorrCoef", {}, (N,), "real"),
    ("PearsonCorrCoef", {"num_outputs": 3}, (N, 3), "real"),
    ("ConcordanceCorrCoef", {}, (N,), "real"),
    ("ConcordanceCorrCoef", {"num_outputs": 3}, (N, 3), "real"),
    ("SpearmanCorrCoef", {}, (N,), "ties"),
    ("SpearmanCorrCoef", {"num_outputs": 3}, (N, 3), "ties"),
    ("KendallRankCorrCoef", {}, (N,), "ties"),
    ("KendallRankCorrCoef", {"variant": "c", "t_test": True, "alternative": "greater"}, (N,), "ties"),
    ("KendallRankCorrCoef", {"variant": "a", "num_outputs": 2}, (N, 2), "ties"),
    ("R2Score", {}, (N,), "real"),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values", "adjusted": 2}, (N, 3), "real"),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted"}, (N, 3), "real"),
    ("ExplainedVariance", {}, (N,), "real"),
    ("ExplainedVariance", {"multioutput": "raw_values"}, (N, 3), "real"),
    ("CosineSimilarity", {"reduction": "mean"}, (N, 3), "real"),
    ("CosineSimilarity", {"reduction": None}, (N, 3), "real"),
    ("KLDivergence", {}, (N, 4), "dist"),
    ("KLDivergence", {"reduction": "none"}, (N, 4), "dist"),
]


def _pair_of_classes(name, kwargs):
    _, _, jax_regression = _jax()
    return getattr(regression, name)(device="cpu", **kwargs), getattr(jax_regression, name)(executor=False, **kwargs)


@pytest.mark.parametrize("case", CLASS_CASES, ids=_ids)
def test_class_matches_jax(case):
    """Three updates then compute, and a forward of a fourth batch (the
    batch value and the accumulated value after it)."""
    jnp = _jax()[0]
    name, kwargs, shape, kind = case
    port, ref = _pair_of_classes(name, kwargs)
    for p, q in _batches(10, shape, kind):
        port.update(torch.from_numpy(p), torch.from_numpy(q))
        ref.update(jnp.asarray(p), jnp.asarray(q))
    _close(port.compute(), ref.compute())
    p, q = _data(20, shape, kind)
    _close(port(torch.from_numpy(p), torch.from_numpy(q)), ref(jnp.asarray(p), jnp.asarray(q)))
    _close(port.compute(), ref.compute())


def test_class_states_keep_the_declared_layout():
    """Counts stay int32 (CSI, totals) or int64 (Pearson's), so every rank
    of a sync holds the same dtypes whether it saw data or not."""
    p, q = _data(11, (N, 3))
    csi = regression.CriticalSuccessIndex(threshold=0.3, device="cpu")
    pearson = regression.PearsonCorrCoef(num_outputs=3, device="cpu")
    mse = regression.MeanSquaredError(num_outputs=3, device="cpu")
    fresh = {type(m).__name__: {k: v.dtype for k, v in m.metric_state.items()} for m in (csi, pearson, mse)}
    for m in (csi, pearson, mse):
        m.update(torch.from_numpy(p), torch.from_numpy(q))
    assert fresh == {type(m).__name__: {k: v.dtype for k, v in m.metric_state.items()} for m in (csi, pearson, mse)}
    assert fresh["PearsonCorrCoef"]["n_total"] == torch.int64 and fresh["CriticalSuccessIndex"]["hits"] == torch.int32


def test_pearson_count_stays_exact_past_2_24():
    """A count of 2**24 + 1 loaded as the state, then 3 more samples: the
    port counts 2**24 + 4 exactly (JAX's float32 count gives 2**24 + 4
    only by rounding 2**24 + 3 up; one more sample leaves it there)."""
    m = regression.PearsonCorrCoef(device="cpu")
    state = m.state()
    state["n_total"] = torch.tensor([2**24 + 1], dtype=torch.int64)
    state["mean_x"], state["mean_y"] = torch.tensor([0.5]), torch.tensor([0.25])
    state["var_x"], state["var_y"], state["corr_xy"] = torch.tensor([2.0e6]), torch.tensor([3.0e6]), torch.tensor([1.0e6])
    m.load_state(state)
    m.update(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 0.0, 2.0]))
    assert int(m.n_total) == 2**24 + 4
    m.update(torch.tensor([1.0]), torch.tensor([1.0]))
    assert int(m.n_total) == 2**24 + 5
    assert np.float32(np.float32(2**24 + 4) + np.float32(1)) == 2**24 + 4


@pytest.mark.parametrize("kind", ["warns", "quiet"])
def test_pearson_near_zero_variance_warning_matches_jax(kind):
    jnp, jax_functional, _ = _jax()
    p, q = _data(12, (N,))
    if kind == "warns":
        p = np.full_like(p, 2.0)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        port = functional.pearson_corrcoef(torch.from_numpy(p), torch.from_numpy(q))
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref = jax_functional.pearson_corrcoef(jnp.asarray(p), jnp.asarray(q))
    said = lambda ws: any("variance" in str(w.message) for w in ws)  # noqa: E731
    assert said(port_w) == said(ref_w) == (kind == "warns")
    _close(port, ref)


@pytest.mark.parametrize(
    "adjusted,n,message",
    [(5, 6, "Division by zero"), (9, 6, "More independent regressions")],
)
def test_adjusted_r2_falls_back_with_a_warning_like_jax(adjusted, n, message):
    jnp, jax_functional, _ = _jax()
    p, q = _data(13, (n,))
    with pytest.warns(UserWarning, match=message):
        port = functional.r2_score(torch.from_numpy(p), torch.from_numpy(q), adjusted=adjusted)
    with pytest.warns(UserWarning, match=message):
        ref = jax_functional.r2_score(jnp.asarray(p), jnp.asarray(q), adjusted=adjusted)
    _close(port, ref)


BAD_ARGUMENTS = [
    ("MeanSquaredError", {"num_outputs": 0}, ValueError),
    ("MeanSquaredError", {"squared": 1}, ValueError),
    ("MeanAbsoluteError", {"num_outputs": -1}, ValueError),
    ("LogCoshError", {"num_outputs": 0}, ValueError),
    ("MinkowskiDistance", {"p": 0.5}, ValueError),
    ("TweedieDevianceScore", {"power": 0.5}, ValueError),
    ("CriticalSuccessIndex", {"threshold": "x"}, ValueError),
    ("CriticalSuccessIndex", {"threshold": 0.5, "keep_sequence_dim": -1}, ValueError),
    ("PearsonCorrCoef", {"num_outputs": 0}, ValueError),
    ("SpearmanCorrCoef", {"num_outputs": 0}, ValueError),
    ("KendallRankCorrCoef", {"variant": "d"}, ValueError),
    ("KendallRankCorrCoef", {"t_test": 1}, ValueError),
    ("KendallRankCorrCoef", {"t_test": True, "alternative": "both"}, ValueError),
    ("R2Score", {"adjusted": -1}, ValueError),
    ("R2Score", {"multioutput": "median"}, ValueError),
    ("ExplainedVariance", {"multioutput": "median"}, ValueError),
    ("CosineSimilarity", {"reduction": "max"}, ValueError),
    ("KLDivergence", {"log_prob": 1}, TypeError),
    ("KLDivergence", {"reduction": "max"}, ValueError),
]


@pytest.mark.parametrize("name,kwargs,error", BAD_ARGUMENTS, ids=lambda v: str(v))
def test_bad_arguments_raise_like_jax(name, kwargs, error):
    _, _, jax_regression = _jax()
    with pytest.raises(error):
        getattr(jax_regression, name)(**kwargs)
    with pytest.raises(error):
        getattr(regression, name)(device="cpu", **kwargs)


BAD_INPUTS = [
    ("mean_squared_error", (4,), (5,), {}),
    ("r2_score", (4, 2, 2), (4, 2, 2), {}),
    ("r2_score", (1,), (1,), {}),
    ("cosine_similarity", (4,), (4,), {}),
    ("kl_divergence", (4,), (4,), {}),
    ("kendall_rank_corrcoef", (4,), (4,), {"variant": "x"}),
    ("explained_variance", (4,), (4,), {"multioutput": "x"}),
    ("tweedie_deviance_score", (4,), (4,), {"power": 0.5}),
    ("minkowski_distance", (4,), (4,), {"p": 0}),
]


@pytest.mark.parametrize("name,shape_p,shape_q,kwargs", BAD_INPUTS, ids=lambda v: str(v))
def test_bad_inputs_raise_value_error_like_jax(name, shape_p, shape_q, kwargs):
    jnp, jax_functional, _ = _jax()
    p, q = np.ones(shape_p, np.float32), np.ones(shape_q, np.float32)
    with pytest.raises(ValueError):
        getattr(jax_functional, name)(jnp.asarray(p), jnp.asarray(q), **kwargs)
    with pytest.raises(ValueError):
        getattr(functional, name)(torch.from_numpy(p), torch.from_numpy(q), **kwargs)


@pytest.mark.parametrize(
    "shape,num_outputs,allow",
    [((4,), 1, False), ((4, 1), 1, False), ((4, 3), 1, False), ((4, 3), 1, True), ((4, 3), 3, False),
     ((4, 3), 2, False), ((4,), 2, False), ((4, 3, 2), 3, False)],
)
def test_check_data_shape_to_num_outputs_matches_jax(shape, num_outputs, allow):
    jnp = _jax()[0]
    from torchmetrics_tpu.functional.regression.utils import _check_data_shape_to_num_outputs as jax_check

    def outcome(check, array):
        try:
            check(array, array, num_outputs, allow)
            return None
        except ValueError as err:
            return str(err)

    x = np.zeros(shape, np.float32)
    assert outcome(_check_data_shape_to_num_outputs, torch.from_numpy(x)) == outcome(jax_check, jnp.asarray(x))


# ------------------------------------------------------------- collections


def _nyu_members(module, **extra):
    """The depth-regression collection of ``chip_smoke.py``'s NYU phase."""
    return {
        "mae": module.MeanAbsoluteError(**extra),
        "mse": module.MeanSquaredError(**extra),
        "rmse": module.MeanSquaredError(squared=False, **extra),
        "msle": module.MeanSquaredLogError(**extra),
        "abs_rel": module.MeanAbsolutePercentageError(**extra),
        "smape": module.SymmetricMeanAbsolutePercentageError(**extra),
        "wmape": module.WeightedMeanAbsolutePercentageError(**extra),
        "rse": module.RelativeSquaredError(**extra),
        "log_cosh": module.LogCoshError(**extra),
        "minkowski": module.MinkowskiDistance(p=3, **extra),
        "tweedie": module.TweedieDevianceScore(power=1.5, **extra),
        "r2": module.R2Score(**extra),
        "explained_variance": module.ExplainedVariance(**extra),
        "pearson": module.PearsonCorrCoef(**extra),
        "concordance": module.ConcordanceCorrCoef(**extra),
    }


def test_collection_compute_groups_match_jax():
    """MSE with RMSE and Pearson with Concordance share state in both
    packages; every other member stands alone; the values agree."""
    import torchmetrics_tpu as jax_tm

    jnp, _, jax_regression = _jax()
    port = tm.MetricCollection(_nyu_members(regression, device="cpu"), device="cpu")
    ref = jax_tm.MetricCollection(_nyu_members(jax_regression, executor=False))
    for p, q in _batches(30, (N,), "positive"):
        port.update(torch.from_numpy(p), torch.from_numpy(q))
        ref.update(jnp.asarray(p), jnp.asarray(q))
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert groups == sorted(sorted(g) for g in ref.compute_groups.values())
    assert ["concordance", "pearson"] in groups and ["mse", "rmse"] in groups
    got, want = port.compute(), ref.compute()
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


# ---------------------------------------------------------------- namespace


def test_every_jax_regression_and_pairwise_name_is_exported():
    import torchmetrics_tpu.functional.pairwise as jax_pairwise
    import torchmetrics_tpu.functional.regression as jax_functional_regression
    import torchmetrics_tpu.regression as jax_regression

    import torchmetrics_tpu_torch.functional.pairwise as pairwise
    import torchmetrics_tpu_torch.functional.regression as functional_regression

    def public(module):
        names = getattr(module, "__all__", None)
        return set(names) if names is not None else {n for n in vars(module) if not n.startswith("_") and callable(getattr(module, n))}

    for jax_module, port_module in (
        (jax_regression, regression),
        (jax_functional_regression, functional_regression),
        (jax_pairwise, pairwise),
    ):
        missing = {n for n in public(jax_module) if not hasattr(port_module, n)}
        assert not missing, (jax_module.__name__, missing)
        missing = {n for n in public(jax_module) if not hasattr(functional if "functional" in jax_module.__name__ else tm, n)}
        assert not missing, (jax_module.__name__, missing)
