"""The port's pairwise distances against the JAX package, and the chunked
Manhattan and Minkowski forms against the unchunked one.

The same seeded numpy rows go through both packages on the CPU, with and
without ``y``, every ``reduction`` and ``zero_diagonal`` setting.
Tolerances:

- rtol 1e-5, atol 1e-5 (float32 products and sums in another order);
- euclidean distances of a row to itself without the diagonal zeroed:
  atol 2e-3. ``|x|² + |x|² − 2 x·x`` cancels to a few ulps of ``|x|²``
  (about 20 here), and its square root is of the order of
  ``sqrt(20 · 2**-23)``, 1.5e-3, in either package;
- chunked against unchunked (one broadcast ``(N, M, D)`` term, as the JAX
  package forms it): rtol 1e-6, atol 0. The chunks cut rows; the sum over
  the features of each pair is the same.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as functional
from torchmetrics_tpu_torch.functional.pairwise import distances

RTOL, ATOL = 1e-5, 1e-5
SELF_EUCLIDEAN_ATOL = 2e-3
NAMES = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
]


def _rows(seed, n, d=6):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("with_y", [True, False], ids=["x_y", "x_x"])
@pytest.mark.parametrize("reduction", [None, "mean", "sum"])
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
def test_pairwise_matches_jax(name, with_y, reduction, zero_diagonal):
    import jax.numpy as jnp

    import torchmetrics_tpu.functional as jax_functional

    x, y = _rows(0, 9), _rows(1, 7)
    kwargs = {"reduction": reduction, "zero_diagonal": zero_diagonal}
    if name == "pairwise_minkowski_distance":
        kwargs["exponent"] = 3
    port = getattr(functional, name)(torch.from_numpy(x), torch.from_numpy(y) if with_y else None, **kwargs)
    ref = getattr(jax_functional, name)(jnp.asarray(x), jnp.asarray(y) if with_y else None, **kwargs)
    self_diagonal = name == "pairwise_euclidean_distance" and not with_y and zero_diagonal is False
    _close(port, ref, atol=SELF_EUCLIDEAN_ATOL if self_diagonal else ATOL)


def _unchunked(x, y, exponent=None):
    term = (x[:, None, :] - y[None, :, :]).abs()
    if exponent is None:
        return term.sum(-1)
    return (term**exponent).sum(-1) ** (1.0 / exponent)


@pytest.mark.parametrize("rows_per_chunk", [1, 3, 4, 100])
@pytest.mark.parametrize("exponent", [None, 1.5, 3])
def test_chunked_equals_unchunked(monkeypatch, rows_per_chunk, exponent):
    """Chunks of 1, 3 (10 rows: a short last chunk), 4 and all rows."""
    x, y = torch.from_numpy(_rows(2, 10, 5)), torch.from_numpy(_rows(3, 7, 5))
    monkeypatch.setattr(distances, "_CHUNK_ELEMENTS", rows_per_chunk * 7 * 5)
    if exponent is None:
        got = functional.pairwise_manhattan_distance(x, y)
    else:
        got = functional.pairwise_minkowski_distance(x, y, exponent=exponent)
    _close(got, _unchunked(x, y, exponent).numpy(), atol=0.0, rtol=1e-6)


def test_zero_diagonal_keeps_nan_as_the_mask_multiply_does():
    """The diagonal is multiplied by 0 (as JAX's ``1 − eye`` mask), so a NaN
    row stays NaN there and an off-diagonal entry is untouched."""
    import jax.numpy as jnp

    import torchmetrics_tpu.functional as jax_functional

    x = _rows(4, 5)
    x[2, 0] = np.nan
    port = functional.pairwise_manhattan_distance(torch.from_numpy(x))
    ref = jax_functional.pairwise_manhattan_distance(jnp.asarray(x))
    np.testing.assert_array_equal(np.isnan(port.numpy()), np.isnan(np.asarray(ref)))
    ok = ~np.isnan(np.asarray(ref))
    np.testing.assert_allclose(port.numpy()[ok], np.asarray(ref)[ok], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "call",
    [
        lambda f, x, y: f.pairwise_minkowski_distance(x, y, exponent=0.5),
        lambda f, x, y: f.pairwise_euclidean_distance(x[0], y),
        lambda f, x, y: f.pairwise_cosine_similarity(x, y[:, :3]),
        lambda f, x, y: f.pairwise_linear_similarity(x, y, reduction="max"),
    ],
    ids=["exponent", "x_1d", "widths", "reduction"],
)
def test_bad_inputs_raise_value_error_like_jax(call):
    import jax.numpy as jnp

    import torchmetrics_tpu.functional as jax_functional

    x, y = _rows(5, 4), _rows(6, 3)
    with pytest.raises(ValueError):
        call(jax_functional, jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(ValueError):
        call(functional, torch.from_numpy(x), torch.from_numpy(y))
