"""The port's clustering functionals and classes against the JAX package.

The same seeded numpy labels and embeddings go through JAX and through the
port on the CPU. Tolerances:

- the contingency table and the pair confusion matrix: bit for bit (the
  port's int64 cells against JAX's int32 counts and float32 pair cells,
  exact below 4,096 samples);
- the expected mutual information: bit for bit (the same float64 sums,
  rounded to float32), and chunked equal to one row at a time;
- the label metrics: 1e-5 (float32 sums in another order); the embedding
  metrics: 1e-5 relative;
- the chunked centroid distances of Davies-Bouldin and Dunn: bit for bit
  against the unchunked form.

Every contingency table is one weightless ``bincount`` dispatch (the gate
log counts it on the CPU too); a label entropy is one more.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.functional.clustering import extrinsic, intrinsic, utils
from torchmetrics_tpu_torch.ops import kernels

TOL = 1e-5
LABEL_FNS = (
    "mutual_info_score", "normalized_mutual_info_score", "adjusted_mutual_info_score", "rand_score",
    "adjusted_rand_score", "fowlkes_mallows_index", "homogeneity_score", "completeness_score", "v_measure_score",
)
EMBEDDING_FNS = ("calinski_harabasz_score", "davies_bouldin_score", "dunn_index")


def _jax():
    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.functional as jax_functional
    from torchmetrics_tpu.functional.clustering import utils as jax_utils

    return jax_tm, jax_functional, jax_utils


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _labels(kind: str, seed: int, n: int = 300, classes: int = 7):
    """A target labeling and a noisy clustering of it: ``kind`` "int"
    (0..classes-1), "sparse" (non-contiguous, negative values) or "single"
    (one predicted cluster)."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, classes, n)
    preds = np.where(rng.rand(n) < 0.3, rng.randint(0, classes + 2, n), (target + 1) % classes)
    if kind == "sparse":
        target, preds = target * 13 - 20, preds * 7 + 1000
    elif kind == "single":
        preds = np.full(n, 4)
    return preds.astype(np.int64), target.astype(np.int64)


def _blobs(seed: int, n: int = 240, k: int = 6, d: int = 5):
    rng = np.random.RandomState(seed)
    centres = rng.randn(k, d) * 4
    labels = rng.randint(0, k, n)
    labels[:k] = np.arange(k)
    data = (centres[labels] + rng.randn(n, d)).astype(np.float32)
    return data, labels * 3 + 1  # non-contiguous labels


@pytest.mark.parametrize("kind", ["int", "sparse", "single"])
@pytest.mark.parametrize("seed", [0, 1])
def test_contingency_and_entropy_against_jax(kind, seed):
    _, _, ju = _jax()
    preds, target = _labels(kind, seed)
    kernels.reset_gate_log()
    got = utils.calculate_contingency_matrix(torch.tensor(preds), torch.tensor(target))
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": 1}
    want = np.asarray(ju.calculate_contingency_matrix(preds, target))
    assert got.dtype == torch.int64 and _np(got).tolist() == want.tolist()
    got_eps = utils.calculate_contingency_matrix(torch.tensor(preds), torch.tensor(target), eps=1e-3)
    np.testing.assert_array_equal(_np(got_eps), np.asarray(ju.calculate_contingency_matrix(preds, target, eps=1e-3)))
    for x in (preds, target):
        np.testing.assert_allclose(_np(utils.calculate_entropy(torch.tensor(x))), np.asarray(ju.calculate_entropy(x)), atol=TOL)
    assert float(utils.calculate_entropy(torch.tensor([], dtype=torch.int64))) == 1.0


@pytest.mark.parametrize("n", [10, 300, 4095])
def test_pair_confusion_matrix_bit_for_bit_below_4096(n):
    _, _, ju = _jax()
    preds, target = _labels("int", 3, n=n)
    want = np.asarray(ju.calculate_pair_cluster_confusion_matrix(preds, target))
    got = utils.calculate_pair_cluster_confusion_matrix(torch.tensor(preds), torch.tensor(target))
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()
    cont = np.asarray(ju.calculate_contingency_matrix(preds, target)).astype(np.float64)
    want64 = np.asarray(ju.calculate_pair_cluster_confusion_matrix(contingency=cont))
    got64 = utils.calculate_pair_cluster_confusion_matrix(contingency=torch.tensor(cont))
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(_np(got64), want64)


def test_pair_confusion_matrix_exact_past_4096():
    """Past 4,096 samples JAX's float32 cells round; the port's are the
    int64 counts, converted once (ROADMAP Queue C)."""
    _, _, ju = _jax()
    preds, target = _labels("int", 4, n=20_011, classes=5)
    cont = np.zeros((5, 7), dtype=np.int64)
    np.add.at(cont, (target, preds), 1)
    n = cont.sum()
    ss = (cont**2).sum()
    cols, rows = (cont.sum(0) ** 2).sum(), (cont.sum(1) ** 2).sum()
    exact = np.array([[n * n - (cols - ss) - (rows - ss) - ss, cols - ss], [rows - ss, ss - n]])
    got = utils.calculate_pair_cluster_confusion_matrix(torch.tensor(preds), torch.tensor(target))
    np.testing.assert_array_equal(_np(got), exact.astype(np.float32))
    jax_cells = np.asarray(ju.calculate_pair_cluster_confusion_matrix(preds, target))
    assert not np.array_equal(jax_cells, exact.astype(np.float32))  # JAX's [0, 0] cancels in float32


@pytest.mark.parametrize("name", LABEL_FNS)
@pytest.mark.parametrize("kind", ["int", "sparse", "single"])
def test_label_metrics_against_jax(name, kind):
    _, jf, _ = _jax()
    preds, target = _labels(kind, 7)
    want = np.asarray(getattr(jf, name)(preds, target))
    got = getattr(F, name)(torch.tensor(preds), torch.tensor(target))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("average_method", ["min", "geometric", "arithmetic", "max"])
def test_normalized_and_adjusted_mi_average_methods(average_method):
    _, jf, _ = _jax()
    preds, target = _labels("int", 8)
    for name in ("normalized_mutual_info_score", "adjusted_mutual_info_score"):
        want = np.asarray(getattr(jf, name)(preds, target, average_method))
        np.testing.assert_allclose(_np(getattr(F, name)(torch.tensor(preds), torch.tensor(target), average_method)), want, atol=TOL)
    want = np.asarray(jf.v_measure_score(preds, target, beta=2.0))
    np.testing.assert_allclose(_np(F.v_measure_score(torch.tensor(preds), torch.tensor(target), beta=2.0)), want, atol=TOL)


def test_identical_and_degenerate_labelings():
    _, jf, _ = _jax()
    x = np.array([0, 0, 1, 1, 2, 2])
    for name in LABEL_FNS:
        np.testing.assert_allclose(_np(getattr(F, name)(torch.tensor(x), torch.tensor(x))), np.asarray(getattr(jf, name)(x, x)), atol=TOL)
    with pytest.raises(ValueError, match="discrete"):
        F.mutual_info_score(torch.tensor([0.5, 1.0]), torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="average_method"):
        F.normalized_mutual_info_score(torch.tensor(x), torch.tensor(x), "median")


@pytest.mark.parametrize("seed", [0, 1])
def test_expected_mutual_info_bit_for_bit_and_chunked(seed, monkeypatch):
    from torchmetrics_tpu.functional.clustering import extrinsic as jax_extrinsic

    preds, target = _labels("int", seed, n=500, classes=9)
    cont = utils.calculate_contingency_matrix(torch.tensor(preds), torch.tensor(target))
    whole = extrinsic.expected_mutual_info_score(cont, 500)
    want = np.asarray(jax_extrinsic.expected_mutual_info_score(_np(cont).astype(np.int32), 500))
    assert whole.numpy().tobytes() == want.astype(np.float32).tobytes()
    monkeypatch.setattr(extrinsic, "_EMI_CHUNK_ELEMENTS", 1)  # one row a chunk, as JAX walks them
    assert extrinsic.expected_mutual_info_score(cont, 500).numpy().tobytes() == whole.numpy().tobytes()
    monkeypatch.setattr(extrinsic, "_EMI_CHUNK_ELEMENTS", 3 * cont.shape[1] * 200)  # three rows a chunk
    assert extrinsic.expected_mutual_info_score(cont, 500).numpy().tobytes() == whole.numpy().tobytes()


@pytest.mark.parametrize("name", EMBEDDING_FNS)
@pytest.mark.parametrize("seed", [0, 1])
def test_embedding_metrics_against_jax(name, seed):
    _, jf, _ = _jax()
    data, labels = _blobs(seed)
    want = np.asarray(getattr(jf, name)(data, labels))
    got = getattr(F, name)(torch.tensor(data), torch.tensor(labels))
    np.testing.assert_allclose(_np(got), want, rtol=TOL)
    if name == "dunn_index":
        want = np.asarray(jf.dunn_index(data, labels, p=1))
        np.testing.assert_allclose(_np(F.dunn_index(torch.tensor(data), torch.tensor(labels), p=1)), want, rtol=TOL)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_chunked_centroid_distances_equal_the_unchunked_form(p, monkeypatch):
    data, labels = _blobs(5, k=9, d=7)
    data_t, labels_t = torch.tensor(data), torch.tensor(labels)
    whole = {name: getattr(F, name)(data_t, labels_t) for name in ("davies_bouldin_score", "dunn_index")}
    dunn_p = F.dunn_index(data_t, labels_t, p=p)
    centroids = torch.randn(9, 7, generator=torch.Generator().manual_seed(p))
    full = torch.linalg.vector_norm(centroids[:, None, :] - centroids[None, :, :], ord=p, dim=-1)
    monkeypatch.setattr(intrinsic, "_CHUNK_ELEMENTS", 2 * 9 * 7)  # two rows a chunk
    assert torch.equal(intrinsic._centroid_distances(centroids, p), full)
    for name, value in whole.items():
        assert torch.equal(getattr(F, name)(data_t, labels_t), value)
    assert torch.equal(F.dunn_index(data_t, labels_t, p=p), dunn_p)


def test_embedding_degenerate_cases_and_errors():
    _, jf, _ = _jax()
    data = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [1.0, 1.0]], dtype=np.float32)
    labels = np.array([0, 0, 1, 1])
    for name in EMBEDDING_FNS:
        want = np.asarray(getattr(jf, name)(data, labels))
        np.testing.assert_allclose(_np(getattr(F, name)(torch.tensor(data), torch.tensor(labels))), want, rtol=TOL)
    with pytest.raises(ValueError, match="greater than one"):
        F.calinski_harabasz_score(torch.tensor(data), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="2D data"):
        F.davies_bouldin_score(torch.zeros(4), torch.tensor(labels))
    with pytest.raises(ValueError, match="floating point"):
        F.dunn_index(torch.zeros(4, 2, dtype=torch.int64), torch.tensor(labels))


def _class_cases():
    preds, target = _labels("int", 11, n=120)
    data, labels = _blobs(12, n=120)
    label_args = {"VMeasureScore": {"beta": 0.5}, "NormalizedMutualInfoScore": {"average_method": "max"},
                  "AdjustedMutualInfoScore": {"average_method": "min"}}
    fn_args = {"VMeasureScore": (0.5,), "NormalizedMutualInfoScore": ("max",), "AdjustedMutualInfoScore": ("min",),
               "DunnIndex": (1,)}
    out = []
    for cls, fn in [("MutualInfoScore", "mutual_info_score"), ("NormalizedMutualInfoScore", "normalized_mutual_info_score"),
                    ("AdjustedMutualInfoScore", "adjusted_mutual_info_score"), ("RandScore", "rand_score"),
                    ("AdjustedRandScore", "adjusted_rand_score"), ("FowlkesMallowsIndex", "fowlkes_mallows_index"),
                    ("HomogeneityScore", "homogeneity_score"), ("CompletenessScore", "completeness_score"),
                    ("VMeasureScore", "v_measure_score")]:
        out.append((cls, label_args.get(cls, {}), (preds, target), fn, fn_args.get(cls, ())))
    for cls, fn in [("CalinskiHarabaszScore", "calinski_harabasz_score"), ("DaviesBouldinScore", "davies_bouldin_score"),
                    ("DunnIndex", "dunn_index")]:
        out.append((cls, {"p": 1} if cls == "DunnIndex" else {}, (data, labels), fn, fn_args.get(cls, ())))
    return out


@pytest.mark.parametrize("case", range(12))
def test_class_against_its_functional_and_jax(case):
    jax_tm, _, _ = _jax()
    cls, kwargs, (a, b), fn, fn_args = _class_cases()[case]
    metric = getattr(tm, cls)(device="cpu", **kwargs)
    theirs = getattr(jax_tm, cls)(**kwargs)
    halves = [(a[:60], b[:60]), (a[60:], b[60:])]
    first = metric(torch.tensor(halves[0][0]), torch.tensor(halves[0][1]))
    np.testing.assert_allclose(_np(first), _np(getattr(F, fn)(torch.tensor(halves[0][0]), torch.tensor(halves[0][1]), *fn_args)), rtol=1e-6)
    metric.update(torch.tensor(halves[1][0]), torch.tensor(halves[1][1]))
    for x, y in halves:
        theirs.update(x, y)
    value = metric.compute()
    np.testing.assert_allclose(_np(value), _np(getattr(F, fn)(torch.tensor(a), torch.tensor(b), *fn_args)), rtol=1e-6)
    np.testing.assert_allclose(_np(value), np.asarray(theirs.compute()), rtol=TOL, atol=TOL)
    state = metric.state()
    assert state["_update_count"] == 2 and all(len(v) == 2 for k, v in state.items() if k != "_update_count")
    metric.reset()
    assert all(len(v) == 0 for v in metric.metric_state.values())


def test_every_jax_clustering_name_is_exported():
    import torchmetrics_tpu.clustering as jax_clustering
    import torchmetrics_tpu.functional.clustering as jax_fclustering

    import torchmetrics_tpu_torch.clustering as clustering
    import torchmetrics_tpu_torch.functional.clustering as fclustering

    assert set(jax_clustering.__all__) <= set(clustering.__all__)
    assert set(jax_fclustering.__all__) <= set(fclustering.__all__)
    for name in jax_clustering.__all__:
        assert getattr(tm, name) is getattr(clustering, name)
    for name in jax_fclustering.__all__:
        assert getattr(F, name) is getattr(fclustering, name)


def test_one_count_a_contingency_and_one_an_entropy():
    preds, target = _labels("int", 13)
    p, t = torch.tensor(preds), torch.tensor(target)
    expected = {"mutual_info_score": 1, "rand_score": 1, "adjusted_rand_score": 1, "fowlkes_mallows_index": 1,
                "normalized_mutual_info_score": 3, "adjusted_mutual_info_score": 3, "homogeneity_score": 3,
                "completeness_score": 3, "v_measure_score": 3}
    for name, count in expected.items():
        kernels.reset_gate_log()
        getattr(F, name)(p, t)
        assert kernels.gate_snapshot()["bincount"]["selections"] == {"reference": count}, name
