"""The port's nominal association functionals and classes against the JAX
package.

The same seeded numpy inputs go through JAX (eager, ``executor=False`` for
the classes) and through the port on the CPU. Tolerances:

- contingency tables: bit for bit (the port's int64 table against JAX's
  float32 one, exact below 2**24 a cell);
- statistics: within 1e-5 (float32 sums in another order; the port's
  table is the same, its chi-square and entropies are formed from it in
  float32 as JAX's are).

Every table of the port is one weightless ``bincount`` dispatch (the gate
log counts it on the CPU too), and a collection of the four table metrics
is one compute group that counts once a batch.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.ops import kernels

TOL = 1e-5
PAIR_FNS = ("cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u")
MATRIX_FNS = tuple(f"{name}_matrix" for name in PAIR_FNS)
CLASSES = ("CramersV", "TschuprowsT", "PearsonsContingencyCoefficient", "TheilsU")
HAS_BIAS = ("cramers_v", "tschuprows_t", "CramersV", "TschuprowsT")


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.functional as jax_functional

    return jnp, jax_tm, jax_functional


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, tol=TOL):
    port, ref = _np(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol, equal_nan=True)


def _pair(kind, seed, n=60, classes=4):
    """Two associated label columns: ``kind`` "int" (0..classes-1),
    "sparse" (non-contiguous, non-zero-based values), "float" (float labels
    with NaNs) or "probs" ((N, C) scores whose argmax is the label)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, classes, n)
    y = np.where(rng.rand(n) < 0.6, x, rng.randint(0, classes, n))
    if kind == "sparse":
        codes = np.array([3, 7, 11, 40, 41])[:classes]
        return codes[x], codes[y]
    if kind == "float":
        xf, yf = x.astype(np.float32), y.astype(np.float32)
        xf[rng.rand(n) < 0.1] = np.nan
        yf[rng.rand(n) < 0.1] = np.nan
        return xf, yf
    if kind == "probs":
        px = rng.rand(n, classes).astype(np.float32)
        px[np.arange(n), x] += 1.0
        return px, y
    return x, y


@pytest.mark.parametrize("fn", PAIR_FNS)
@pytest.mark.parametrize("kind", ["int", "sparse", "float", "probs"])
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_pair_functionals_match_jax(fn, kind, nan_strategy):
    jnp, _, jf = _jax()
    preds, target = _pair(kind, seed=len(fn) + len(kind))
    kwargs = {"nan_strategy": nan_strategy, "nan_replace_value": 0.0 if nan_strategy == "replace" else None}
    for extra in ({"bias_correction": True}, {"bias_correction": False}) if fn in HAS_BIAS else ({},):
        got = getattr(F, fn)(torch.as_tensor(preds), torch.as_tensor(target), **kwargs, **extra)
        want = getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs, **extra)
        _close(got, want)


@pytest.mark.parametrize("fn", PAIR_FNS)
def test_pair_table_is_one_bincount_and_matches_jax(fn):
    from torchmetrics_tpu.functional.nominal.metrics import _nominal_confmat_from_values as jax_table

    from torchmetrics_tpu_torch.functional.nominal.metrics import _nominal_confmat_from_values

    jnp, _, jf = _jax()
    preds, target = _pair("sparse", seed=3)
    kernels.reset_gate_log()
    table = _nominal_confmat_from_values(torch.as_tensor(preds), torch.as_tensor(target))
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": 1}
    assert table.dtype == torch.int64
    np.testing.assert_array_equal(_np(table), np.asarray(jax_table(jnp.asarray(preds), jnp.asarray(target))))
    kernels.reset_gate_log()
    getattr(F, fn)(torch.as_tensor(preds), torch.as_tensor(target))
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": 1}


@pytest.mark.parametrize("fn", MATRIX_FNS)
@pytest.mark.parametrize("kind", ["int", "float"])
def test_matrix_functionals_match_jax(fn, kind):
    jnp, _, jf = _jax()
    rng = np.random.RandomState(len(fn))
    base = rng.randint(0, 3, 50)
    cols = [np.where(rng.rand(50) < 0.5, base, rng.randint(0, 4, 50)) for _ in range(4)]
    matrix = np.stack(cols, axis=1)
    if kind == "float":
        matrix = matrix.astype(np.float32)
        matrix[rng.rand(*matrix.shape) < 0.05] = np.nan
    got = getattr(F, fn)(torch.as_tensor(matrix))
    want = getattr(jf, fn)(jnp.asarray(matrix))
    _close(got, want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_matches_jax(mode):
    jnp, jax_tm, jf = _jax()
    rng = np.random.RandomState(7)
    if mode == "counts":
        batches = [rng.multinomial(5, [0.5, 0.3, 0.2], size=n) for n in (20, 13)]
    else:
        batches = [rng.rand(n, 3, 5).astype(np.float32) for n in (20, 13)]
    got = F.fleiss_kappa(torch.as_tensor(batches[0]), mode=mode)
    _close(got, jf.fleiss_kappa(jnp.asarray(batches[0]), mode=mode))
    port, ref = tm.FleissKappa(mode=mode, device="cpu"), jax_tm.FleissKappa(mode=mode, executor=False)
    for b in batches:
        port.update(torch.as_tensor(b))
        ref.update(jnp.asarray(b))
    _close(port.compute(), ref.compute())


def test_fleiss_kappa_refuses_wrong_inputs_like_jax():
    jnp, _, jf = _jax()
    for ratings, mode in ((np.ones((3, 2), np.float32), "counts"), (np.ones((3, 2), np.int64), "probs")):
        with pytest.raises(ValueError):
            jf.fleiss_kappa(jnp.asarray(ratings), mode=mode)
        with pytest.raises(ValueError):
            F.fleiss_kappa(torch.as_tensor(ratings), mode=mode)
    with pytest.raises(ValueError, match="mode"):
        F.fleiss_kappa(torch.ones((3, 2), dtype=torch.int64), mode="bad")


def _class_batches(kind, seed, classes=5):
    return [_pair(kind, seed + i, n=n, classes=classes) for i, n in enumerate((40, 17, 33))]


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("kind", ["int", "float", "probs"])
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_classes_match_jax(name, kind, nan_strategy):
    jnp, jax_tm, _ = _jax()
    kwargs = {"nan_strategy": nan_strategy, "nan_replace_value": 1.0 if nan_strategy == "replace" else None}
    for extra in ({"bias_correction": True}, {"bias_correction": False}) if name in HAS_BIAS else ({},):
        port = getattr(tm, name)(num_classes=5, device="cpu", **kwargs, **extra)
        ref = getattr(jax_tm, name)(num_classes=5, executor=False, **kwargs, **extra)
        for preds, target in _class_batches(kind, seed=len(name)):
            port.update(torch.as_tensor(preds), torch.as_tensor(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        assert port.confmat.dtype == torch.int64
        np.testing.assert_array_equal(_np(port.confmat), np.asarray(ref.confmat).astype(np.int64))
        _close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", CLASSES)
def test_out_of_range_labels_raise_like_jax(name):
    jnp, jax_tm, _ = _jax()
    for preds, target in (([0, 1, 3], [0, 1, 2]), ([0, -1, 2], [0, 1, 2]), ([0.0, 1.0, 2.0], [0.0, 3.5, 1.0])):
        with pytest.raises(ValueError, match=r"Expected label values in \[0, 3\)"):
            getattr(jax_tm, name)(num_classes=3, executor=False).update(jnp.asarray(preds), jnp.asarray(target))
        port = getattr(tm, name)(num_classes=3, device="cpu")
        with pytest.raises(ValueError, match=r"Expected label values in \[0, 3\)"):
            port.update(torch.as_tensor(preds), torch.as_tensor(target))
        assert int(port.confmat.sum()) == 0 and port.update_count == 0


def test_dropped_nan_rows_escape_the_range_check():
    preds = torch.tensor([0.0, float("nan"), 2.0])
    target = torch.tensor([1.0, 9.0, 2.0])
    m = tm.CramersV(num_classes=3, nan_strategy="drop", device="cpu")
    m.update(preds, target)
    assert m.confmat.tolist() == [[0, 0, 0], [1, 0, 0], [0, 0, 1]]


@pytest.mark.parametrize("name", ("CramersV", "TschuprowsT"))
def test_unusable_bias_correction_warns_and_gives_nan_like_jax(name):
    jnp, jax_tm, _ = _jax()
    preds, target = np.array([0, 1, 0, 1]), np.array([0, 0, 0, 0])  # one row: unusable
    port = getattr(tm, name)(num_classes=2, device="cpu")
    ref = getattr(jax_tm, name)(num_classes=2, executor=False)
    port.update(torch.as_tensor(preds), torch.as_tensor(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = port.compute()
    assert any("bias correction" in str(w.message) for w in caught)
    want = ref.compute()
    assert np.isnan(float(got)) == np.isnan(float(want))


def test_class_arguments_are_validated_like_jax():
    with pytest.raises(ValueError, match="num_classes"):
        tm.CramersV(num_classes=0, device="cpu")
    with pytest.raises(ValueError, match="nan_strategy"):
        tm.TheilsU(num_classes=3, nan_strategy="zero", device="cpu")
    with pytest.raises(ValueError, match="nan_replace"):
        tm.TheilsU(num_classes=3, nan_replace_value=None, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tm.FleissKappa(mode="x", device="cpu")


def test_collection_of_table_metrics_is_one_group_and_one_count_a_batch():
    coll = tm.MetricCollection(
        [
            tm.CramersV(5, bias_correction=False, device="cpu"),
            tm.TschuprowsT(5, bias_correction=False, device="cpu"),
            tm.PearsonsContingencyCoefficient(5, device="cpu"),
            tm.TheilsU(5, device="cpu"),
        ],
        device="cpu",
    )
    batches = _class_batches("int", seed=11)
    for preds, target in batches:
        kernels.reset_gate_log()
        coll.update(torch.as_tensor(preds), torch.as_tensor(target))
        assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": 1}
    assert [len(g) for g in coll.compute_groups.values()] == [4]
    preds = torch.as_tensor(np.concatenate([b[0] for b in batches]))
    target = torch.as_tensor(np.concatenate([b[1] for b in batches]))
    got = coll.compute()
    _close(got["CramersV"], F.cramers_v(preds, target, bias_correction=False))
    _close(got["TheilsU"], F.theils_u(preds, target))


def test_state_past_float32_exactness_is_exact():
    m = tm.PearsonsContingencyCoefficient(2, device="cpu")
    m.load_state({"confmat": torch.tensor([[2**24, 0], [0, 0]], dtype=torch.int64)})
    m.update(torch.tensor([0, 1, 1]), torch.tensor([0, 1, 1]))
    assert m.confmat.tolist() == [[2**24 + 1, 0], [0, 2]]


def test_jax_state_loads_into_the_port():
    jnp, jax_tm, _ = _jax()
    preds, target = _pair("int", seed=5, classes=4)
    ref = jax_tm.TheilsU(num_classes=4, executor=False)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    exported = {"confmat": torch.as_tensor(np.asarray(ref.state()["confmat"]).astype(np.int64))}
    port = tm.TheilsU(num_classes=4, device="cpu")
    port.load_state(exported)
    _close(port.compute(), ref.compute())
