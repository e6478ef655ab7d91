"""The port on the card: the CUDA kernel against its plain version, and the
classification path on CUDA against the same path on the CPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The file
imports only PyTorch and the port, so it also runs where JAX is not
installed::

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Counts with 0/1 weights must be bit-exact (float atomics on integers below
2**24 are order-independent); float-weighted rows agree within rtol=1e-5
(atomic order changes from run to run).
"""
import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.classification import (
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassJaccardIndex,
)
from torchmetrics_tpu_torch.ops import bincount, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _case(seed, n, length, k=1, weighted=False):
    rng = np.random.RandomState(seed)
    spread = max(1, length // 10)
    x = rng.randint(-spread, length + spread, n).astype(np.int32)
    w = rng.rand(k, n).astype(np.float32) if weighted else np.ones((k, n), np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.mark.parametrize("k,length,n", [(1, 4, 1 << 20), (1, 361, 1 << 20), (1, 1000 * 1000, 1024), (3, 15, 100_000)])
def test_kernel_matches_plain_version(cuda_device, k, length, n):
    x, w = (t.to(cuda_device) for t in _case(k + length, n, length, k=k, weighted=k > 1))
    before = bincount.launches
    got = bincount._wbincount_cuda(x, w, length)
    torch.cuda.synchronize()
    assert bincount.launches == before + 1
    ref = bincount._wbincount_reference(x, w, length)
    if k == 1:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)


def test_empty_input_launches_nothing(cuda_device):
    before = bincount.launches
    out = bincount._wbincount_cuda(
        torch.empty(0, dtype=torch.int32, device=cuda_device), torch.empty((2, 0), device=cuda_device), 7
    )
    assert bincount.launches == before
    assert tuple(out.shape) == (2, 7) and not bool(out.any())


def test_cuda_tensors_dispatch_to_the_kernel(cuda_device):
    kernels.reset_gate_log()
    before = bincount.launches
    bincount.weighted_bincount(torch.tensor([0, 1, 1, 3], device=cuda_device), length=4)
    assert kernels.gate_snapshot()["bincount"]["path"] == "cuda"
    assert bincount.launches == before + 1


def _members(device):
    return {
        "accuracy": MulticlassAccuracy(num_classes=19, ignore_index=255, device=device),
        "f1": MulticlassF1Score(num_classes=19, ignore_index=255, device=device),
        "jaccard": MulticlassJaccardIndex(num_classes=19, ignore_index=255, device=device),
        "confmat": MulticlassConfusionMatrix(num_classes=19, ignore_index=255, device=device),
    }


def test_collection_on_card_equals_collection_on_cpu(cuda_device):
    on_card = tm.MetricCollection(_members(None))  # the default places state on the card
    assert on_card.device == cuda_device and on_card["confmat"].confmat.device == cuda_device
    on_cpu = tm.MetricCollection(_members("cpu"), device="cpu")
    rng = np.random.RandomState(0)
    bincount.launches = 0
    for _ in range(3):
        preds = torch.from_numpy(rng.randn(2, 19, 64, 96).astype(np.float32))
        target = torch.from_numpy(rng.randint(0, 19, (2, 64, 96)))
        target[torch.from_numpy(rng.rand(2, 64, 96) < 0.05)] = 255
        on_card.update(preds.to(cuda_device), target.to(cuda_device))
        on_cpu.update(preds, target)
    assert bincount.launches == 3  # one shared count per collection update
    for leader, st in on_cpu.state().items():
        for field, value in st.items():
            got = on_card.state()[leader][field]
            assert got == value if field == "_update_count" else torch.equal(got.cpu(), value), field
    for name, value in on_cpu.compute().items():
        torch.testing.assert_close(on_card.compute()[name].cpu(), value, rtol=1e-6, atol=0.0)


def test_input_on_the_cpu_is_refused_by_a_card_metric(cuda_device):
    m = MulticlassAccuracy(num_classes=3)
    with pytest.raises(RuntimeError, match="never copied"):
        m.update(torch.tensor([0, 1]), torch.tensor([0, 1]))


@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_small_histogram_families_on_card_equal_cpu(cuda_device, task):
    from torchmetrics_tpu_torch.classification import Accuracy, ConfusionMatrix, F1Score

    kw = {"task": task, "ignore_index": -1}
    if task == "multilabel":
        kw["num_labels"] = 6

    def members(device):
        return [Accuracy(**kw, device=device), ConfusionMatrix(**kw, device=device), F1Score(**kw, device=device)]

    on_card = tm.MetricCollection(members(cuda_device), device=cuda_device)
    on_cpu = tm.MetricCollection(members("cpu"), device="cpu")
    rng = np.random.RandomState(1)
    shape = (4096,) if task == "binary" else (512, 6, 8)
    bincount.launches = 0
    for _ in range(2):
        preds = torch.from_numpy(rng.rand(*shape).astype(np.float32))  # probabilities: no sigmoid near 0.5
        target = torch.from_numpy(rng.randint(0, 2, shape))
        target[torch.from_numpy(rng.rand(*shape) < 0.1)] = -1
        on_card.update(preds.to(cuda_device), target.to(cuda_device))
        on_cpu.update(preds, target)
    assert bincount.launches == 2
    for name, value in on_cpu.compute().items():
        got = on_card.compute()[name].cpu()
        if value.is_floating_point():
            torch.testing.assert_close(got, value, rtol=1e-6, atol=0.0)
        else:
            assert torch.equal(got, value), name


# ---------------------------------------------------------------- binned_curve

def _curve_case(seed, n, len_t, unsorted=False, edges=False):
    rng = np.random.RandomState(seed)
    thr = rng.rand(len_t).astype(np.float32) if unsorted else (np.arange(len_t, dtype=np.float32) * np.float32(1 / max(len_t - 1, 1)))
    preds = rng.rand(n).astype(np.float32)
    if edges:
        thr[len_t // 2:] = thr[: len_t - len_t // 2]  # duplicated thresholds
        preds[rng.rand(n) < 0.05] = np.nan
        on = rng.rand(n) < 0.3
        preds[on] = thr[rng.randint(0, len_t, int(on.sum()))]  # scores exactly on a threshold
    target = rng.randint(0, 2, n).astype(np.int32)
    valid = rng.rand(n) >= 0.05
    return [torch.from_numpy(a) for a in (preds, target, valid, thr)]


@pytest.mark.parametrize(
    "n,len_t,unsorted,edges",
    [
        (100_000, 100, False, False),  # bench config 6, scaled down
        (200_000, 200, False, False),
        (1 << 20, 1000, False, False),
        (100_000, 50_000, True, False),  # histogram and thresholds in device memory
        (100_000, 70_000, True, False),
        (50_000, 18_000, True, False),  # the largest shared-memory histograms
        (50_000, 19_500, True, False),
        (20_000, 64, True, True),
        (0, 5, False, False),
    ],
)
def test_binned_curve_kernel_matches_plain_version(cuda_device, n, len_t, unsorted, edges):
    from torchmetrics_tpu_torch.ops import binned_curve

    preds, target, valid, thr = (t.to(cuda_device) for t in _curve_case(n + len_t, n, len_t, unsorted, edges))
    args = [preds, target, valid, *binned_curve.sort_thresholds(thr)]
    before = binned_curve.launches
    got = binned_curve._binned_counts_cuda(*args)
    torch.cuda.synchronize()
    assert binned_curve.launches == before + 1
    assert torch.equal(got, binned_curve._binned_counts_reference(*args))
    assert torch.equal(got.cpu(), binned_curve._binned_counts_reference(*(a.cpu() for a in args)))


def test_binary_auroc_on_card_equals_cpu(cuda_device):
    from torchmetrics_tpu_torch.classification import BinaryAUROC
    from torchmetrics_tpu_torch.ops import binned_curve

    on_card = BinaryAUROC(thresholds=100, ignore_index=-1)
    on_cpu = BinaryAUROC(thresholds=100, ignore_index=-1, device="cpu")
    assert on_card.thresholds.device == cuda_device
    kernels.reset_gate_log()
    before = binned_curve.launches
    rng = np.random.RandomState(3)
    for _ in range(3):
        preds = torch.from_numpy(rng.rand(50_000).astype(np.float32))
        target = torch.from_numpy(rng.randint(0, 2, 50_000))
        target[torch.from_numpy(rng.rand(50_000) < 0.05)] = -1
        on_card.update(preds.to(cuda_device), target.to(cuda_device))
        on_cpu.update(preds, target)
    assert binned_curve.launches == before + 3
    assert kernels.gate_snapshot()["binned_curve"]["selections"] == {"cuda": 3, "reference": 3}
    assert torch.equal(on_card.confmat.cpu(), on_cpu.confmat)
    torch.testing.assert_close(on_card.compute().cpu(), on_cpu.compute(), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("interface", ["functional", "modular"])
def test_binned_auroc_under_inference_mode_on_card_equals_cpu(cuda_device, interface):
    from torchmetrics_tpu_torch.classification import BinaryAUROC
    from torchmetrics_tpu_torch.functional import binary_auroc
    from torchmetrics_tpu_torch.ops import binned_curve

    rng = np.random.RandomState(5)
    preds = torch.from_numpy(rng.rand(50_000).astype(np.float32))
    target = torch.from_numpy(rng.randint(0, 2, 50_000))
    before = binned_curve.launches
    with torch.inference_mode():
        if interface == "functional":
            on_card = binary_auroc(preds.to(cuda_device), target.to(cuda_device), thresholds=100)
            on_cpu = binary_auroc(preds, target, thresholds=100)
        else:
            card_metric = BinaryAUROC(thresholds=100).to(cuda_device)
            cpu_metric = BinaryAUROC(thresholds=100, device="cpu")
            card_metric.update(preds.to(cuda_device), target.to(cuda_device))
            cpu_metric.update(preds, target)
            on_card, on_cpu = card_metric.compute(), cpu_metric.compute()
    assert binned_curve.launches == before + 1
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-6, atol=0.0)


def test_classwise_curves_and_calibration_on_card_equal_cpu(cuda_device):
    from torchmetrics_tpu_torch.classification import MulticlassAveragePrecision, MulticlassCalibrationError

    def members(device):
        return {
            "ap": MulticlassAveragePrecision(num_classes=10, thresholds=50, device=device),
            "ce": MulticlassCalibrationError(num_classes=10, device=device),
        }

    on_card = tm.MetricCollection(members(cuda_device), device=cuda_device)
    on_cpu = tm.MetricCollection(members("cpu"), device="cpu")
    rng = np.random.RandomState(4)
    kernels.reset_gate_log()
    for _ in range(2):
        probs = rng.rand(4096, 10).astype(np.float32)
        preds = torch.from_numpy(probs / probs.sum(1, keepdims=True))
        target = torch.from_numpy(rng.randint(0, 10, 4096))
        on_card.update(preds.to(cuda_device), target.to(cuda_device))
        on_cpu.update(preds, target)
    assert kernels.gate_snapshot()["bincount"]["selections"]["cuda"] == 4  # two members, two updates
    assert torch.equal(on_card["ap"].confmat.cpu(), on_cpu["ap"].confmat)
    assert torch.equal(on_card["ce"].bin_count.cpu(), on_cpu["ce"].bin_count)
    for name, value in on_cpu.compute().items():
        torch.testing.assert_close(on_card.compute()[name].cpu(), value, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------- retrieval_topk_stats

def _topk_case(seed, q, length, binary=True):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, length + 1, q).astype(np.int32)
    t = rng.randint(0, 2, (q, length)) if binary else rng.rand(q, length)
    t = np.where(np.arange(length)[None, :] < counts[:, None], t, 0).astype(np.float32)
    return torch.from_numpy(t), torch.from_numpy(counts)


@pytest.mark.parametrize("top_k", [-1, 1, 10, 100])
@pytest.mark.parametrize("q,length", [(700, 1000), (5000, 100), (37, 53), (3, 1), (1, 4099)])
def test_topk_stats_kernel_is_bit_equal_to_plain_version(cuda_device, q, length, top_k):
    from torchmetrics_tpu_torch.ops import topk_kernel

    t, counts = (a.to(cuda_device) for a in _topk_case(q + length, q, length))
    before = topk_kernel.launches
    got = topk_kernel._topk_stats_cuda(t, counts, top_k)
    torch.cuda.synchronize()
    assert topk_kernel.launches == before + 1
    assert torch.equal(got, topk_kernel._topk_stats_reference(t, counts, top_k))
    assert torch.equal(got.cpu(), topk_kernel._topk_stats_reference(t.cpu(), counts.cpu(), top_k))


def test_topk_stats_kernel_on_fractional_targets(cuda_device):
    """Sums of fractional targets run in another order than the plain body's."""
    from torchmetrics_tpu_torch.ops import topk_kernel

    t, counts = (a.to(cuda_device) for a in _topk_case(9, 300, 257, binary=False))
    got = topk_kernel._topk_stats_cuda(t, counts, 7)
    torch.testing.assert_close(got, topk_kernel._topk_stats_reference(t, counts, 7), rtol=1e-5, atol=1e-5)


def test_retrieval_collection_on_card_equals_cpu(cuda_device):
    from torchmetrics_tpu_torch import retrieval
    from torchmetrics_tpu_torch.ops import topk_kernel

    def members(device):
        return {
            "mrr": retrieval.RetrievalMRR(top_k=10, device=device),
            "ndcg": retrieval.RetrievalNormalizedDCG(top_k=10, device=device),
            "map": retrieval.RetrievalMAP(device=device),
            "precision": retrieval.RetrievalPrecision(top_k=10, device=device),
            "recall": retrieval.RetrievalRecall(top_k=100, device=device),
            "hit_rate": retrieval.RetrievalHitRate(top_k=10, device=device),
        }

    on_card = tm.MetricCollection(members(cuda_device), device=cuda_device)
    on_cpu = tm.MetricCollection(members("cpu"), device="cpu")
    rng = np.random.RandomState(6)
    for b in range(3):
        indexes = torch.from_numpy(rng.randint(0, 50, 20_000) + 50 * b)
        target = torch.from_numpy((rng.rand(20_000) < 0.02).astype(np.int64))
        preds = torch.from_numpy(rng.randn(20_000).astype(np.float32)) + 2.0 * target
        on_card.update(preds.to(cuda_device), target.to(cuda_device), indexes=indexes.to(cuda_device))
        on_cpu.update(preds, target, indexes=indexes)
    before = topk_kernel.launches
    got, want = on_card.compute(), on_cpu.compute()
    assert topk_kernel.launches == before + 3  # precision@10, recall@100, hit rate@10
    for name, value in want.items():
        torch.testing.assert_close(got[name].cpu(), value, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- ssim_windows

#: kernel against plain body: float32 sums of products in another order
#: (fmaf in tap order against cuBLAS or cuDNN), on inputs in [0, 1]
SSIM_TOL = 2e-6


def _window_case(seed, m, hp, wp, kh, kw):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(m, hp, wp).astype(np.float32))
    g_h = torch.from_numpy(rng.rand(kh).astype(np.float32))
    g_w = torch.from_numpy(rng.rand(kw).astype(np.float32))
    return x, g_h / g_h.sum(), g_w / g_w.sum()


@pytest.mark.parametrize(
    "m,hp,wp,kh,kw",
    [
        (60, 266, 266, 11, 11),  # bench config 3
        (5, 77, 130, 11, 11),  # MS-SSIM's coarsest 1080p scale
        (4, 100, 37, 7, 7),
        (3, 40, 200, 9, 3),
        (2, 11, 11, 11, 11),  # the window is the plane
        (2, 8, 9, 1, 1),
        (1, 130, 140, 65, 65),  # the most taps the kernel takes
        (1, 2100, 40, 11, 11),  # the plain body's convolution branch
    ],
)
def test_ssim_windows_kernel_matches_plain_version(cuda_device, m, hp, wp, kh, kw):
    from torchmetrics_tpu_torch.ops import ssim_kernel

    x, g_h, g_w = (a.to(cuda_device) for a in _window_case(m + hp + kh, m, hp, wp, kh, kw))
    before = ssim_kernel.launches
    got = ssim_kernel._windowed_cuda(x, g_h, g_w)
    torch.cuda.synchronize()
    assert ssim_kernel.launches == before + 1
    assert tuple(got.shape) == (m, hp - kh + 1, wp - kw + 1)
    torch.testing.assert_close(got, ssim_kernel._windowed_reference(x, g_h, g_w), rtol=SSIM_TOL, atol=SSIM_TOL)


def test_ssim_windows_kernel_refuses_too_many_taps(cuda_device):
    from torchmetrics_tpu_torch.ops import ssim_kernel

    x, g_h, g_w = (a.to(cuda_device) for a in _window_case(1, 1, 100, 100, 66, 5))
    with pytest.raises(ValueError, match="at most 65 taps"):
        ssim_kernel._windowed_cuda(x, g_h, g_w)


def test_ssim_windows_kernel_backward_matches_autograd(cuda_device):
    """Backward relaunches the kernel on the padded gradient; the gradients
    are N(0, 1) sums, so the tolerance is 1e-5."""
    from torchmetrics_tpu_torch.ops import ssim_kernel

    x, g_h, g_w = (a.to(cuda_device) for a in _window_case(2, 6, 70, 90, 11, 7))
    x_card = x.clone().requires_grad_()
    x_plain = x.clone().requires_grad_()
    grad = torch.randn((6, 60, 84), generator=torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    before = ssim_kernel.launches
    ssim_kernel._windowed_cuda(x_card, g_h, g_w).backward(grad)
    assert ssim_kernel.launches == before + 2
    ssim_kernel._windowed_reference(x_plain, g_h, g_w).backward(grad)
    torch.testing.assert_close(x_card.grad, x_plain.grad, rtol=1e-5, atol=1e-5)


def test_ssim_classes_on_card_equal_cpu(cuda_device):
    from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure
    from torchmetrics_tpu_torch.ops import ssim_kernel

    def members(device):
        return {
            "ssim": StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
            "ms_ssim": MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device),
        }

    on_card = tm.MetricCollection(members(cuda_device), device=cuda_device)
    on_cpu = tm.MetricCollection(members("cpu"), device="cpu")
    rng = np.random.RandomState(7)
    before = ssim_kernel.launches
    for _ in range(2):
        preds = torch.from_numpy(rng.rand(2, 3, 180, 200).astype(np.float32))
        target = (preds + 0.05 * torch.from_numpy(rng.randn(2, 3, 180, 200).astype(np.float32))).clamp(0, 1)
        on_card.update(preds.to(cuda_device), target.to(cuda_device))
        on_cpu.update(preds, target)
    assert ssim_kernel.launches == before + 2 * (1 + 5)
    for name, value in on_cpu.compute().items():
        torch.testing.assert_close(on_card.compute()[name].cpu(), value, rtol=1e-5, atol=1e-5)


def _covariance(f, n, decay, device, seed=0):
    """A covariance of ``n`` samples with eigenvalues about i^-decay, made
    on the card (rank n - 1 when n <= f)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, f), generator=g, device=device, dtype=torch.float64)
    x = x * torch.arange(1, f + 1, device=device, dtype=torch.float64) ** (-decay / 2)
    q, _ = torch.linalg.qr(torch.randn((f, f), generator=g, device=device, dtype=torch.float64))
    return torch.cov((x @ q.T).T).to(torch.float32).contiguous()


@pytest.mark.parametrize("f,n", [(64, 1000), (100, 1000), (768, 10000), (2048, 10000)])
def test_sqrtm_kernel_matches_plain_version(cuda_device, f, n):
    """16 float32 steps summed in another order than cuBLAS's: elementwise
    within 1e-3 of max |ref| on full-rank covariances."""
    from torchmetrics_tpu_torch.ops import sqrtm_kernel

    a = _covariance(f, n, 1.0, cuda_device, seed=f)
    before = sqrtm_kernel.launches, sqrtm_kernel.calls
    got = sqrtm_kernel._sqrtm_cuda(a)
    torch.cuda.synchronize()
    assert (sqrtm_kernel.launches, sqrtm_kernel.calls) == (before[0] + 33, before[1] + 1)
    ref = sqrtm_kernel._sqrtm_ns_reference(a)
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())


def test_sqrtm_kernel_stays_finite_on_a_rank_deficient_covariance(cuda_device):
    from torchmetrics_tpu_torch.ops import sqrtm_kernel

    a = _covariance(512, 100, 1.0, cuda_device)
    y = sqrtm_kernel._sqrtm_cuda(a).double()
    assert bool(torch.isfinite(y).all())
    assert float(torch.linalg.norm(y @ y - a.double()) / torch.linalg.norm(a.double())) < 1e-3


def test_fid_on_card_equals_cpu(cuda_device):
    """The card's FID (Newton-Schulz kernel) against the CPU's (eigh): one
    kernel call a compute, FID within 1e-3 relative."""
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.ops import kernels, sqrtm_kernel

    rng = np.random.RandomState(3)
    real = torch.from_numpy(rng.rand(600, 256).astype(np.float32))
    fake = torch.from_numpy((rng.rand(600, 256) * 1.3 + 0.05).astype(np.float32))
    values = []
    for device in (cuda_device, "cpu"):
        fid = FrechetInceptionDistance(feature_extractor=lambda x: x, num_features=256, device=device)
        fid.update(real.to(device), real=True)
        fid.update(fake.to(device), real=False)
        before = sqrtm_kernel.calls
        values.append(float(fid.compute()))
        assert sqrtm_kernel.calls == before + (1 if device == cuda_device else 0)
    assert kernels.gate_snapshot()["fid_sqrtm"]["selections"]["cuda"] >= 1
    assert abs(values[0] - values[1]) <= 1e-3 * abs(values[1])


def test_inception_network_on_card_equals_cpu(cuda_device):
    """Two images through random weights, TF32 off on the card: every tap
    within 1e-4 of max |ref|."""
    from torchmetrics_tpu_torch.models import inception
    from torchmetrics_tpu_torch.utils.compute import full_float32

    torch.manual_seed(0)
    state = inception.InceptionV3Features().state_dict()
    imgs = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 3, 48, 40)).astype(np.uint8))
    for tap in (64, 768, 2048, "logits"):
        on_cpu = inception.inception_feature_extractor(state, tap, device="cpu")(imgs)
        with full_float32():
            on_card = inception.inception_feature_extractor(state, tap, device=cuda_device)(imgs.to(cuda_device))
        assert float((on_card.cpu() - on_cpu).abs().max()) <= 1e-4 * float(on_cpu.abs().max())
