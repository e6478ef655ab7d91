"""The port on the card: the CUDA kernel against its plain version, and the
classification path on CUDA against the same path on the CPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The file
imports only PyTorch and the port, so it also runs where JAX is not
installed::

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Weightless counts must be bit-exact at any size (int64, integer atomics),
counts with 0/1 weights bit-exact below 2**24 (float atomics on integers
are order-independent there); float-weighted rows agree within rtol=1e-5
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


@pytest.mark.parametrize(
    "length,n,offset",
    [(4, 1 << 20, 0), (361, 4 * 1024 * 2048, 0), (15, 100_003, 0), (361, 1 << 20, 1), (1000 * 1000, 1 << 16, 0), (7, 3, 0)],
)
def test_weightless_kernel_matches_plain_version(cuda_device, length, n, offset):
    """``weights=None``: every in-range index counts 1, bit-equal to the
    plain body; an offset view takes the kernel's unaligned scalar loop, N
    not a multiple of 4 its tail, 10^6 bins its global-atomic regime."""
    x, _ = _case(length + n, n + offset, length)
    x = x.to(cuda_device)[offset:]
    before = bincount.launches
    got = bincount._wbincount_cuda(x, None, length)
    torch.cuda.synchronize()
    assert bincount.launches == before + 1
    assert torch.equal(got, bincount._wbincount_reference(x, None, length))


@pytest.mark.parametrize("weights", ["none", "ones", "fractional"])
def test_skewed_small_histogram_matches_plain_version(cuda_device, weights):
    """L = 4 with 90% of the indices in one bin (the contended case of the
    binary family), 2^22 indices, some out of range."""
    rng = np.random.RandomState(5)
    n = 1 << 22
    x = np.where(rng.rand(n) < 0.9, 2, rng.randint(-1, 6, n)).astype(np.int32)
    x = torch.from_numpy(x).to(cuda_device)
    w = None
    if weights != "none":
        w = torch.from_numpy(rng.rand(1, n).astype(np.float32) if weights == "fractional" else np.ones((1, n), np.float32))
        w = w.to(cuda_device)
    got = bincount._wbincount_cuda(x, w, 4)
    ref = bincount._wbincount_reference(x, w, 4)
    if weights == "fractional":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got, ref)


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


#: (dtype, ignore_index, mask) forms the kernel reads the target in
CURVE_FORMS = {
    "int64_ignore": (torch.int64, -1, False),
    "int32_ignore": (torch.int32, -1, False),
    "uint8_ignore": (torch.uint8, 255, False),
    "int64_mask": (torch.int64, None, True),
    "uint8_all": (torch.uint8, None, False),
}


def _curve_form_args(device, n, len_t, form, edges=False, offset=0, seed=0):
    """Kernel arguments in one of ``CURVE_FORMS`` (an ``offset`` view makes
    every pointer unaligned, so the kernel takes its scalar loads)."""
    from torchmetrics_tpu_torch.ops import binned_curve

    dtype, ignore, masked = CURVE_FORMS[form]
    preds, target, valid, thr = _curve_case(seed + n + len_t, n + offset, len_t, unsorted=edges, edges=edges)
    target = target.to(dtype)
    if ignore is not None:
        target[torch.from_numpy(np.random.RandomState(seed).rand(n + offset) < 0.05)] = ignore
    preds, target, valid = (a.to(device)[offset:] for a in (preds, target, valid))
    return [preds, target, valid if masked else None, *binned_curve.sort_thresholds(thr.to(device)), ignore]


@pytest.mark.parametrize(
    "n,len_t,edges,offset",
    [
        (1_000_000, 100, False, 0),  # bench config 6
        (1_000_003, 100, True, 0),  # a tail of 3, NaN scores, duplicated thresholds, scores on a threshold
        (200_000, 100, False, 1),  # unaligned: scalar loads
        (300_000, 4095, True, 0),  # the largest one-launch grid of buckets
        (100_000, 5000, True, 0),  # two tiles: the multi-launch scan
        (50_000, 25_000, True, 0),  # thresholds in device memory
        (0, 100, False, 0),
        (5, 3, False, 0),
    ],
)
@pytest.mark.parametrize("form", list(CURVE_FORMS))
def test_binned_curve_target_forms_match_plain_version(cuda_device, form, n, len_t, edges, offset):
    """The target as the metric holds it (int64, int32 or uint8, with an
    ignore_index, a mask or neither) gives the plain body's counts exactly."""
    from torchmetrics_tpu_torch.ops import binned_curve

    args = _curve_form_args(cuda_device, n, len_t, form, edges, offset)
    before = binned_curve.launches
    got = binned_curve._binned_counts_cuda(*args)
    torch.cuda.synchronize()
    assert binned_curve.launches == before + 1
    assert torch.equal(got, binned_curve._binned_counts_reference(*args))
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    assert torch.equal(got.cpu(), binned_curve._binned_counts_reference(*cpu))


def _device_kernel_rows(fn, calls):
    """(name, count) of every device event ``torch.profiler`` records over
    ``calls`` calls of ``fn`` (after a warm-up call outside and one inside
    the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)
    ) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [
        (ev.key, ev.count) for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and not ev.key.startswith(("ProfilerStep", "Activity Buffer"))
    ]


@pytest.mark.parametrize("len_t,kernels", [(100, 1), (4095, 1), (5000, 4)])
def test_binned_curve_launches_no_memset(cuda_device, len_t, kernels):
    """Up to 4,095 thresholds a call is one kernel, with no memset and no
    other device work; above, the multi-launch scan also runs no memset. The
    trace can drop a launch, so a kernel is counted at most once a call."""
    from torchmetrics_tpu_torch.ops import binned_curve

    args = _curve_form_args(cuda_device, 1_000_000, len_t, "int64_ignore")
    calls = 5
    rows = _device_kernel_rows(lambda: binned_curve._binned_counts_cuda(*args), calls)
    names = [name for name, _ in rows]
    assert not [name for name in names if "memset" in name.lower() or "fill" in name.lower()], rows
    assert len(names) == kernels, rows
    assert all("binned_" in name for name in names), rows
    assert all(1 <= count <= calls for _, count in rows), rows


def test_binned_curve_on_two_streams_at_once_then_repeated_is_exact(cuda_device):
    """Two streams call concurrently (each with its own ticket and histogram),
    then one stream calls again and again: every count is exact, so the
    reused scratch is left as the next call needs it."""
    from torchmetrics_tpu_torch.ops import binned_curve

    cases = [
        _curve_form_args(cuda_device, 1_000_000, 100, "int64_ignore", seed=1),
        _curve_form_args(cuda_device, 700_001, 1000, "int32_ignore", edges=True, seed=2),
    ]
    refs = [binned_curve._binned_counts_reference(*args) for args in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(binned_curve._binned_counts_cuda(*cases[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, refs[i]) for o in outs[i]), f"stream {i}"
    for _ in range(10):
        for args, ref in zip(cases, refs):
            assert torch.equal(binned_curve._binned_counts_cuda(*args), ref)


def test_stream_scratch_keeps_the_largest_size_up_to_its_cap(cuda_device):
    """A stream keeps buffers of the largest sizes it asked for, exactly; a
    request past the cap gets zeroed buffers that are not kept; a dropped
    stream (a failed launch) makes new ones."""
    from torchmetrics_tpu_torch.ops import native

    scratch = native.StreamScratch()
    dev = cuda_device.index
    stream = native.current_stream(dev)
    first = scratch.grow(dev, stream, 100, 50)
    assert scratch.get(dev, stream) is first and (first[3], first[5]) == (100, 50)
    wider = scratch.grow(dev, stream, 40, 200)
    assert scratch.get(dev, stream) is wider and (wider[3], wider[5]) == (100, 200)
    assert scratch.grow(dev, stream, 60, 60) is wider
    big = scratch.grow(dev, stream, native.StreamScratch.KEEP_BYTES, 16)
    assert big[3] == native.StreamScratch.KEEP_BYTES and not big[0].any() and scratch.get(dev, stream) is wider
    assert scratch.get(dev, native.current_stream(dev) + 1) is None
    scratch.drop(dev, stream)
    assert scratch.get(dev, stream) is None


def test_a_call_on_another_device_restores_the_current_device(cuda_device):
    """The C entry switches to the tensors' device and back: torch reads its
    current device from the runtime, so a device left switched would send
    later work to the wrong card."""
    from torchmetrics_tpu_torch.ops import binned_curve, topk_kernel

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    current = torch.cuda.current_device()
    other = torch.device("cuda", 1 if current == 0 else 0)
    args = _curve_form_args(other, 100_000, 100, "int64_ignore")
    got = binned_curve._binned_counts_cuda(*args)
    assert torch.cuda.current_device() == current
    t, counts = (a.to(other) for a in _topk_case(3, 500, 100))
    stats = topk_kernel._topk_stats_cuda(t, counts, 10)
    assert torch.cuda.current_device() == current
    torch.cuda.synchronize(other)
    assert torch.equal(got, binned_curve._binned_counts_reference(*args))
    assert torch.equal(stats, topk_kernel._topk_stats_reference(t, counts, 10))


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


@pytest.mark.parametrize("length", [1, 7, 20, 31, 64, 65, 100, 128, 129, 256, 257, 512, 513, 1000])
def test_topk_stats_short_rows_are_bit_equal_to_plain_version(cuda_device, length):
    """Rows of every length around the steps of the kernel's pick of lanes
    by L (4 up to 64 values, 8 up to 128, 16 up to 256, 32 up to 512, 16
    above), so each group width sums rows."""
    from torchmetrics_tpu_torch.ops import topk_kernel

    t, counts = (a.to(cuda_device) for a in _topk_case(length, 3001, length))
    for top_k in (-1, 1, 10):
        got = topk_kernel._topk_stats_cuda(t, counts, top_k)
        assert torch.equal(got, topk_kernel._topk_stats_reference(t, counts, top_k))


def test_topk_stats_unaligned_rows_and_no_rows(cuda_device):
    """A grid whose base is 4 bytes past a 16-byte boundary takes the scalar
    loads; Q = 0 gives an empty result without a launch."""
    from torchmetrics_tpu_torch.ops import topk_kernel

    t, counts = (a.to(cuda_device) for a in _topk_case(8, 900, 100))
    shifted = torch.empty(t.numel() + 1, device=cuda_device)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert torch.equal(topk_kernel._topk_stats_cuda(shifted, counts, 10), topk_kernel._topk_stats_reference(t, counts, 10))
    before = topk_kernel.launches
    empty = topk_kernel._topk_stats_cuda(t[:0], counts[:0], 10)
    assert tuple(empty.shape) == (0, 4) and topk_kernel.launches == before


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
        (1, 130, 140, 65, 65),
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


@pytest.mark.parametrize(
    "m,hp,wp,kh,kw,passes",
    [
        (2, 150, 160, 67, 67, 1),  # sigma 9.3's gaussian: still on the strip kernel
        (2, 200, 210, 129, 131, 1),
        (2, 260, 270, 201, 203, 2),  # too long for shared memory: two launches
    ],
)
def test_ssim_windows_kernel_takes_any_tap_count(cuda_device, m, hp, wp, kh, kw, passes):
    """Windows of any length up to the plane: the strip kernel while its ring
    fits in shared memory, two 1-D passes through a global intermediate
    beyond (both launches counted)."""
    from torchmetrics_tpu_torch.ops import ssim_kernel

    x, g_h, g_w = (a.to(cuda_device) for a in _window_case(kh + kw, m, hp, wp, kh, kw))
    before = ssim_kernel.launches
    got = ssim_kernel._windowed_cuda(x, g_h, g_w)
    torch.cuda.synchronize()
    assert ssim_kernel.launches == before + passes
    torch.testing.assert_close(got, ssim_kernel._windowed_reference(x, g_h, g_w), rtol=SSIM_TOL, atol=SSIM_TOL)


#: fused kernel against its plain version: per-image SSIM and cs within 1e-5
#: (float32 moments summed in another order, then E[x^2] - mu^2 and a
#: division; the means themselves are float64 sums in the kernel), the map
#: within 2e-4 (a pixel of small variance divides a rounding difference by
#: little, as in the tests against the JAX package)
FUSED_TOL = 1e-5
FUSED_MAP_TOL = 2e-4


@pytest.mark.parametrize(
    "shape,sigma,uniform,data_range",
    [
        ((2, 3, 181, 203), 1.5, None, 1.0),  # ragged edges, several strips
        ((1, 2, 37, 90), 1.5, None, None),  # a plane smaller than one strip; data_range from the data
        ((2, 1, 1, 140), 1.5, None, 1.0),  # n = 1 down
        ((1, 2, 64, 1), 1.5, None, (0.1, 0.9)),  # n = 1 across
        ((1, 3, 5, 8), 1.5, None, 1.0),  # no larger than the padding: NaN
        ((2, 2, 96, 96), 9.3, None, 1.0),  # 67 taps
        ((1, 1, 150, 150), 18.6, None, 1.0),  # 131 taps: two launches
        ((2, 3, 70, 300), 1.5, 7, 1.0),  # uniform 7-tap window, 11-tap padding
    ],
)
@pytest.mark.parametrize("full_image", [False, True])
def test_ssim_fused_kernel_matches_plain_version(cuda_device, shape, sigma, uniform, data_range, full_image):
    from torchmetrics_tpu_torch.functional.image.ssim import _ssim_update
    from torchmetrics_tpu_torch.ops import ssim_kernel

    rng = np.random.RandomState(sum(shape))
    preds = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    target = torch.from_numpy(np.clip(preds.numpy() + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32))
    kw = dict(sigma=sigma, data_range=data_range, return_full_image=full_image)
    if uniform:
        kw.update(gaussian_kernel=False, kernel_size=uniform)
    before = ssim_kernel.launches
    got = _ssim_update(preds.to(cuda_device), target.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert ssim_kernel.launches == before + (2 if sigma > 10 else 1)
    want = _ssim_update(preds, target, **kw)
    got_cs = _ssim_update(preds.to(cuda_device), target.to(cuda_device), **dict(kw, return_contrast_sensitivity=True))
    want_cs = _ssim_update(preds, target, **dict(kw, return_contrast_sensitivity=True))
    for g, w, tol in [(got, want, FUSED_TOL), (got_cs, want_cs, FUSED_TOL)]:
        g, w = (g, w) if isinstance(w, tuple) else ((g,), (w,))
        for a, b in zip(g, w):
            t = FUSED_MAP_TOL if b.ndim > 1 else tol
            torch.testing.assert_close(a.cpu(), b, rtol=t, atol=t, equal_nan=True)
    if shape[-2:] == (5, 8):
        assert bool(torch.isnan(got[0] if full_image else got).all())


def test_ssim_routes_by_gradient_on_card(cuda_device):
    """No gradient: one fused launch. A gradient: the stack through the
    generic kernel (one launch) and its backward (one more), and the
    gradient equals the plain chain's."""
    from torchmetrics_tpu_torch.functional import structural_similarity_index_measure as ssim
    from torchmetrics_tpu_torch.ops import ssim_kernel

    rng = np.random.RandomState(3)
    preds = torch.from_numpy(rng.rand(2, 3, 64, 70).astype(np.float32))
    target = torch.from_numpy(rng.rand(2, 3, 64, 70).astype(np.float32))
    kernels.reset_gate_log()
    before = ssim_kernel.launches
    ssim(preds.to(cuda_device), target.to(cuda_device), data_range=1.0)
    gate = kernels.gate_snapshot()
    assert ssim_kernel.launches == before + 1
    assert gate["ssim_fused"]["selections"] == {"cuda": 1} and "ssim_windows" not in gate
    p_card = preds.to(cuda_device).requires_grad_()
    p_cpu = preds.clone().requires_grad_()
    kernels.reset_gate_log()
    before = ssim_kernel.launches
    ssim(p_card, target.to(cuda_device), data_range=1.0).backward()
    assert ssim_kernel.launches == before + 2
    gate = kernels.gate_snapshot()
    assert gate["ssim_windows"]["selections"] == {"cuda": 1} and "ssim_fused" not in gate
    ssim(p_cpu, target, data_range=1.0).backward()
    torch.testing.assert_close(p_card.grad.cpu(), p_cpu.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(0, 3, 32, 36), (2, 0, 32, 36)], ids=["no_images", "no_channels"])
@pytest.mark.parametrize("grad", [False, True], ids=["fused", "generic"])
def test_ssim_with_no_planes_equals_cpu_without_launching(cuda_device, shape, grad):
    """An empty batch or no channels: no plane to window, so no launch on
    either route, and the CPU's result (no images, or NaN per image)."""
    from torchmetrics_tpu_torch.functional.image.ssim import _ssim_update
    from torchmetrics_tpu_torch.ops import ssim_kernel

    kw = dict(data_range=1.0, return_full_image=True)
    before = ssim_kernel.launches
    got = _ssim_update(torch.zeros(shape, device=cuda_device, requires_grad=grad), torch.zeros(shape, device=cuda_device), **kw)
    torch.cuda.synchronize()
    assert ssim_kernel.launches == before
    want = _ssim_update(torch.zeros(shape), torch.zeros(shape), **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a.detach().cpu(), b.detach(), equal_nan=True)


def test_weightless_bincount_is_exact_past_2_24(cuda_device):
    """2**24 + 3 equal indices: an exact int64 count (float32 ones stop at
    2**24), and the confusion matrix on the card gives the same."""
    from torchmetrics_tpu_torch.functional.classification import multiclass_confusion_matrix

    n = 2**24 + 3
    x = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    got = bincount._wbincount_cuda(x, None, 2)
    assert got.dtype == torch.int64 and got.tolist() == [[n, 0]]
    cm = multiclass_confusion_matrix(x, x, num_classes=2, validate_args=False)
    assert int(cm[0, 0]) == n


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


#: the sqrtm kernel against its plain body, elementwise, scaled by max |ref|:
#: two float64 runs of KERNEL_ITERS steps whose products sum in other orders
#: (chip_smoke.py's SQRTM_TOL)
SQRTM_TOL = 1e-9


def _covariance(f, n, decay, device, seed=0):
    """A covariance of ``n`` samples with eigenvalues about i^-decay, made
    on the card (rank n - 1 when n <= f)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, f), generator=g, device=device, dtype=torch.float64)
    x = x * torch.arange(1, f + 1, device=device, dtype=torch.float64) ** (-decay / 2)
    q, _ = torch.linalg.qr(torch.randn((f, f), generator=g, device=device, dtype=torch.float64))
    return torch.cov((x @ q.T).T).to(torch.float32).contiguous()


@pytest.mark.parametrize("f,n", [(64, 1000), (100, 1000), (257, 2000), (768, 10000), (2048, 10000)])
def test_sqrtm_kernel_matches_plain_version(cuda_device, f, n):
    """KERNEL_ITERS float64 steps, float64 in and out, summed in another
    order than cuBLAS's DGEMM: elementwise within SQRTM_TOL of max |ref| on
    full-rank covariances (an odd F takes the kernel's 8-byte copies)."""
    from torchmetrics_tpu_torch.ops import sqrtm_kernel

    a = _covariance(f, n, 1.0, cuda_device, seed=f).double()
    before = sqrtm_kernel.launches, sqrtm_kernel.calls
    got = sqrtm_kernel._sqrtm_cuda(a)
    torch.cuda.synchronize()
    assert (sqrtm_kernel.launches, sqrtm_kernel.calls) == (before[0] + 1 + 2 * sqrtm_kernel.KERNEL_ITERS, before[1] + 1)
    assert got.dtype == torch.float64
    ref = sqrtm_kernel._sqrtm_ns_reference(a)
    assert float((got - ref).abs().max()) <= SQRTM_TOL * float(ref.abs().max())


def test_sqrtm_kernel_stays_finite_on_a_rank_deficient_covariance(cuda_device):
    from torchmetrics_tpu_torch.ops import sqrtm_kernel

    a = _covariance(512, 100, 1.0, cuda_device).double()
    y = sqrtm_kernel._sqrtm_cuda(a)
    assert bool(torch.isfinite(y).all())
    assert float(torch.linalg.norm(y @ y - a) / torch.linalg.norm(a)) < 1e-3


def test_sqrtm_kernel_fid_on_a_dominant_mode_is_within_1e3_of_float64(cuda_device):
    """F = 256, one mode of standard deviation 10 over eigenvalues i^-2, 12
    dead features: FID from the kernel's root within 1e-3 of a float64 eigh
    FID (16 float32 steps miss it by about 3e-3)."""
    from torchmetrics_tpu_torch.image.fid import _fid_from_root
    from torchmetrics_tpu_torch.ops import sqrtm_kernel

    f, n, dead = 256, 2000, 12
    q, _ = np.linalg.qr(np.random.RandomState(1000 + f).randn(f, f))
    moments = []
    for scale, shift, seed in ((1.0, 0.0, 7), (1.2, 0.05, 8)):
        rng = np.random.RandomState(seed)
        x = scale * (rng.randn(n, f) * np.arange(1, f + 1) ** -1.0) @ q.T + shift
        x += 10.0 * scale * rng.randn(n, 1) * q[:, -1]
        x[:, f - dead:] = 0.0
        moments += [torch.from_numpy(x.mean(0)), torch.from_numpy(np.cov(x, rowvar=False).astype(np.float32)).double()]
    mu1, s1, mu2, s2 = (m.to(cuda_device) for m in moments)
    e, v = torch.linalg.eigh(s1)
    fid64 = float(_fid_from_root(mu1, s1, mu2, s2, (v * torch.sqrt(torch.clamp(e, min=0.0))) @ v.T))
    fid = float(_fid_from_root(mu1, s1, mu2, s2, sqrtm_kernel._sqrtm_cuda(s1.contiguous())))
    assert abs(fid - fid64) <= 1e-3 * abs(fid64)


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


# ---------------------------------------------------------- sync under NCCL


@pytest.fixture
def nccl_world(cuda_device, tmp_path):
    """A one-rank NCCL world (a real communicator: its collectives launch
    NCCL kernels on the card), from a ``file://`` store."""
    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0, device_id=cuda_device
    )
    yield cuda_device
    dist.destroy_process_group()


def _sync_families(device):
    """Every synced family, updated on seeded inputs on ``device``: name ->
    (metric or collection)."""
    from torchmetrics_tpu_torch import classification as cls
    from torchmetrics_tpu_torch import image, retrieval

    g = torch.Generator(device=device).manual_seed(0)
    c = 20
    counts = tm.MetricCollection(
        {
            "accuracy": cls.MulticlassAccuracy(num_classes=c),
            "f1": cls.MulticlassF1Score(num_classes=c),
            "confmat": cls.MulticlassConfusionMatrix(num_classes=c),
            "specificity": cls.MulticlassSpecificity(num_classes=c),
            "hamming": cls.MulticlassHammingDistance(num_classes=c),
            "mcc": cls.MulticlassMatthewsCorrCoef(num_classes=c),
            "kappa": cls.MulticlassCohenKappa(num_classes=c),
        }
    )
    curves = tm.MetricCollection(
        {"binned": cls.BinaryAUROC(thresholds=50), "exact": cls.BinaryAUROC(thresholds=None)}
    )
    ranking = tm.MetricCollection({"map": retrieval.RetrievalMAP(), "mrr": retrieval.RetrievalMRR()})
    aggregators = tm.MetricCollection(
        {"sum": tm.SumMetric(), "mean": tm.MeanMetric(), "max": tm.MaxMetric(), "min": tm.MinMetric(),
         "cat": tm.CatMetric(), "running": tm.RunningMean(window=3)}
    )
    ssim = image.StructuralSimilarityIndexMeasure(data_range=1.0)
    fid = image.FrechetInceptionDistance(feature_extractor=lambda x: x, num_features=64)
    for i in range(3):
        counts.update(torch.randn((256, c), generator=g, device=device), torch.randint(0, c, (256,), generator=g, device=device))
        target = torch.randint(0, 2, (1000,), generator=g, device=device)
        curves.update(torch.rand(1000, generator=g, device=device), target)
        ranking.update(
            torch.rand(300, generator=g, device=device), torch.randint(0, 2, (300,), generator=g, device=device),
            indexes=torch.arange(300, device=device) // 10 + 30 * i,
        )
        aggregators.update(torch.rand(7, generator=g, device=device))
        ssim.update(*(torch.rand((2, 3, 32, 32), generator=g, device=device) for _ in range(2)))
        fid.update(torch.randn((100, 64), generator=g, device=device), real=True)
        fid.update(torch.randn((100, 64), generator=g, device=device) + 0.2, real=False)
    return {"counts": counts, "curves": curves, "ranking": ranking, "aggregators": aggregators, "ssim": ssim, "fid": fid}


def _bit_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bit_equal(x, y) for x, y in zip(a, b))
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    # a None-reduced field stacks one row per rank: in a world of one, the
    # same elements
    return a.dtype == b.dtype and torch.equal(a.reshape(-1), b.reshape(-1))


def _flat_lists(state):
    """A state with every list field concatenated (a synced list is one
    tensor, or one per rank)."""
    return {k: (torch.cat([torch.atleast_1d(t) for t in v]) if isinstance(v, list) and v else v) for k, v in state.items()}


def test_nccl_sync_in_a_world_of_one_changes_nothing(nccl_world):
    """Synced values equal unsynced ones bit for bit for every family, and
    so does every field ``functional_sync`` returns (the update count too);
    the sync runs through NCCL's all_reduce and all_gather."""
    from torchmetrics_tpu_torch.parallel import sync as psync

    before = psync.all_reduces + psync.all_gathers
    for name, m in _sync_families(nccl_world).items():
        local = m.functional_compute(m.state())  # no sync
        synced = m.compute()  # sync_on_compute, through NCCL
        assert _bit_equal(synced, local), name
        members = m.state() if isinstance(m, tm.MetricCollection) else {name: m.state()}
        after = m.functional_sync(m.state()) if isinstance(m, tm.MetricCollection) else {name: m.functional_sync(m.state())}
        for leader, st in members.items():
            assert int(after[leader]["_update_count"]) == st["_update_count"] > 0
            assert _bit_equal(
                _flat_lists({k: v for k, v in after[leader].items() if k != "_update_count"}),
                _flat_lists({k: v for k, v in st.items() if k != "_update_count"}),
            ), (name, leader)
    assert psync.all_reduces + psync.all_gathers > before


def test_a_cpu_state_under_nccl_raises(nccl_world):
    m = tm.SumMetric(device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    with pytest.raises(RuntimeError, match="'nccl' backend cannot take tensors on cpu"):
        m.compute()
    assert float(m.sum_value) == 3.0 and not m._is_synced
    # and a card metric's states go through
    card = tm.SumMetric()
    card.update(torch.tensor([1.0, 2.0], device=nccl_world))
    assert float(card.compute()) == 3.0


# ------------------------------------- the rest of classification on the card


def _state_equal_to_cpu(on_card, on_cpu):
    """Count states bit-equal, float sums within rtol 1e-5 (reduction order)."""
    for name, value in on_cpu.metric_state.items():
        got = on_card.metric_state[name]
        if isinstance(value, list):
            got, value = torch.cat(got), torch.cat(value)
        if value.is_floating_point():
            torch.testing.assert_close(got.cpu(), value, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got.cpu(), value), name


def _value_equal_to_cpu(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-5, atol=1e-6)
    elif isinstance(want, tuple):
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-6)
        assert torch.equal(got[1].cpu(), want[1])  # the selected thresholds
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def _rest_cases():
    """(id, build(device), batch(rng), launching kernel module name or None)."""
    from torchmetrics_tpu_torch import classification as cls

    def scores(rng, n=4096, c=19):
        target = rng.randint(0, c, n)
        logits = rng.randn(n, c).astype(np.float32) + 2.0 * np.eye(c, dtype=np.float32)[target]
        return torch.from_numpy(logits), torch.from_numpy(target)

    def multilabel(rng, n=512, labels=80):
        target = (rng.rand(n, labels) < 0.04).astype(np.int64)
        preds = (rng.rand(n, labels) * 0.7 + 0.3 * target).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target)

    def binary(rng, n=20_000):
        target = (rng.rand(n) < 0.1).astype(np.int64)
        preds = (rng.rand(n) * 0.8 + 0.2 * target).astype(np.float32)
        target[rng.rand(n) < 0.03] = -1
        return torch.from_numpy(preds), torch.from_numpy(target)

    def fairness(rng, n=20_000):
        preds, target = binary(rng, n)
        return preds, target, torch.from_numpy(rng.randint(-1, 9, n))  # ids -1 and 8 are dropped

    def dice_labels(rng, n=8 * 512 * 512, c=19):
        target = rng.randint(0, c, n)
        target[rng.rand(n) < 0.05] = 255  # out of range: counts, as in the JAX package
        preds = np.where(rng.rand(n) < 0.7, target, rng.randint(0, c, n))
        return torch.from_numpy(preds), torch.from_numpy(target)

    return [
        ("dice_labels", lambda d: cls.Dice(num_classes=19, average="macro", ignore_index=0, device=d), dice_labels, "bincount"),
        ("dice_scores", lambda d: cls.Dice(num_classes=19, average="weighted", device=d), scores, "bincount"),
        ("dice_micro_inferred", lambda d: cls.Dice(device=d), dice_labels, "bincount"),
        ("group_stat_rates", lambda d: cls.BinaryGroupStatRates(num_groups=8, ignore_index=-1, validate_args=False, device=d), fairness, "bincount"),
        ("fairness", lambda d: cls.BinaryFairness(num_groups=8, ignore_index=-1, validate_args=False, device=d), fairness, "bincount"),
        ("mc_recall_at_precision", lambda d: cls.MulticlassRecallAtFixedPrecision(19, 0.5, thresholds=100, device=d), scores, "bincount"),
        ("ml_precision_at_recall", lambda d: cls.MultilabelPrecisionAtFixedRecall(80, 0.5, thresholds=100, device=d), multilabel, "bincount"),
        ("mc_specificity_at_sensitivity", lambda d: cls.MulticlassSpecificityAtSensitivity(19, 0.5, thresholds=100, device=d), scores, "bincount"),
        ("ml_sensitivity_at_specificity", lambda d: cls.MultilabelSensitivityAtSpecificity(80, 0.9, thresholds=100, device=d), multilabel, "bincount"),
        ("bin_recall_at_precision", lambda d: cls.BinaryRecallAtFixedPrecision(0.8, thresholds=100, ignore_index=-1, device=d), binary, "binned_curve"),
        ("bin_precision_at_recall", lambda d: cls.BinaryPrecisionAtFixedRecall(0.5, thresholds=100, ignore_index=-1, device=d), binary, "binned_curve"),
        ("bin_sensitivity_at_specificity", lambda d: cls.BinarySensitivityAtSpecificity(0.9, thresholds=100, ignore_index=-1, device=d), binary, "binned_curve"),
        ("bin_specificity_at_sensitivity", lambda d: cls.BinarySpecificityAtSensitivity(0.5, thresholds=100, ignore_index=-1, device=d), binary, "binned_curve"),
        ("bin_exact_sensitivity_at_specificity", lambda d: cls.BinarySensitivityAtSpecificity(0.9, ignore_index=-1, device=d), binary, None),
        ("mc_exact_match", lambda d: cls.MulticlassExactMatch(num_classes=19, device=d), scores, None),
        ("ml_exact_match", lambda d: cls.MultilabelExactMatch(num_labels=80, device=d), multilabel, None),
        ("mc_hinge", lambda d: cls.MulticlassHingeLoss(num_classes=19, device=d), scores, None),
        ("mc_hinge_ova", lambda d: cls.MulticlassHingeLoss(num_classes=19, multiclass_mode="one-vs-all", squared=True, device=d), scores, None),
        ("bin_hinge", lambda d: cls.BinaryHingeLoss(ignore_index=-1, device=d), binary, None),
        ("coverage_error", lambda d: cls.MultilabelCoverageError(num_labels=80, device=d), multilabel, None),
        ("ranking_ap", lambda d: cls.MultilabelRankingAveragePrecision(num_labels=80, device=d), multilabel, None),
        ("ranking_loss", lambda d: cls.MultilabelRankingLoss(num_labels=80, device=d), multilabel, None),
    ]


@pytest.mark.parametrize("case", _rest_cases(), ids=lambda c: c[0])
def test_rest_of_classification_on_card_equals_cpu(cuda_device, case):
    """Every new family on CUDA tensors against the port on the CPU: counts
    bit-equal, values within rtol 1e-5 and the selected thresholds equal.
    Dice, fairness and the multiclass and multilabel fixed points count on
    ``bincount``, the binary binned fixed points on ``binned_curve``: one
    launch an update."""
    from torchmetrics_tpu_torch.ops import binned_curve

    _, build, batch, kernel = case
    on_card, on_cpu = build(cuda_device), build("cpu")
    counters = {"bincount": bincount, "binned_curve": binned_curve}
    before = {k: m.launches for k, m in counters.items()}
    rng = np.random.RandomState(31)
    for _ in range(3):
        inputs = batch(rng)
        on_card.update(*(t.to(cuda_device) for t in inputs))
        on_cpu.update(*inputs)
    launched = {k: m.launches - before[k] for k, m in counters.items()}
    assert launched == {k: (3 if k == kernel else 0) for k in counters}
    _state_equal_to_cpu(on_card, on_cpu)
    _value_equal_to_cpu(on_card.compute(), on_cpu.compute())


def test_fixed_points_share_one_count_with_auroc_on_card(cuda_device):
    """AUROC and two fixed points on one (T, C, 2, 2) state form one compute
    group: three counts on the first update, one an update after it."""
    from torchmetrics_tpu_torch import classification as cls

    kw = {"num_classes": 19, "thresholds": 100, "validate_args": False, "device": cuda_device}
    coll = tm.MetricCollection(
        {
            "auroc": cls.MulticlassAUROC(**kw),
            "recall_at_precision": cls.MulticlassRecallAtFixedPrecision(min_precision=0.5, **kw),
            "specificity_at_sensitivity": cls.MulticlassSpecificityAtSensitivity(min_sensitivity=0.5, **kw),
        },
        device=cuda_device,
    )
    g = torch.Generator(device=cuda_device).manual_seed(3)
    before = bincount.launches
    for _ in range(4):
        coll.update(
            torch.randn((2048, 19), generator=g, device=cuda_device),
            torch.randint(0, 19, (2048,), generator=g, device=cuda_device),
        )
    assert bincount.launches - before == 3 + 3
    assert [len(group) for group in coll.compute_groups.values()] == [3]


# ------------------------------------------------- the rest of image (generic ssim_windows)

#: the generic entry's main-path shapes of the rest of image: VIF's 17-tap
#: scale-0 window at DIV2K's 1356 x 2040 (batch 4), UQI's 11-tap window over
#: its 5·B·C stack, the 8-tap uniform window of RMSE-SW, RASE and SCC, and
#: D_s's 7-tap uniform window at 512 x 512 (20 images x 8 bands)
REST_OF_IMAGE_SHAPES = [
    (4, 1356, 2040, 17, 17),
    (60, 1366, 2050, 11, 11),
    (12, 1363, 2047, 8, 8),
    (160, 518, 518, 7, 7),
]


@pytest.mark.parametrize("m,hp,wp,kh,kw", REST_OF_IMAGE_SHAPES)
def test_ssim_windows_kernel_at_the_rest_of_image_shapes(cuda_device, m, hp, wp, kh, kw):
    from torchmetrics_tpu_torch.ops import ssim_kernel

    x, g_h, g_w = (a.to(cuda_device) for a in _window_case(m + kh, m, hp, wp, kh, kw))
    before = ssim_kernel.launches
    got = ssim_kernel._windowed_cuda(x, g_h, g_w)
    torch.cuda.synchronize()
    assert ssim_kernel.launches == before + 1
    torch.testing.assert_close(got, ssim_kernel._windowed_reference(x, g_h, g_w), rtol=SSIM_TOL, atol=SSIM_TOL)


@pytest.mark.parametrize("taps", [17, 9, 5, 3])
def test_ssim_windows_backward_at_vif_taps(cuda_device, taps):
    """VIF's gaussians through the kernel's backward (the same kernel over
    the padded gradient with reversed taps) against autograd of the plain body."""
    from torchmetrics_tpu_torch.functional.image.vif import _filter_1d
    from torchmetrics_tpu_torch.ops import ssim_kernel

    x, _, _ = _window_case(taps, 3, 90, 75, taps, taps)
    g = _filter_1d(taps, taps / 5)
    weight = torch.rand((3, 90 - taps + 1, 75 - taps + 1), generator=torch.Generator().manual_seed(taps))
    x_card = x.to(cuda_device).requires_grad_()
    x_cpu = x.clone().requires_grad_()
    (ssim_kernel._windowed_cuda(x_card, g.to(cuda_device), g.to(cuda_device)) * weight.to(cuda_device)).sum().backward()
    (ssim_kernel._windowed_reference(x_cpu, g, g) * weight).sum().backward()
    torch.testing.assert_close(x_card.grad.cpu(), x_cpu.grad, rtol=1e-5, atol=1e-6)


def _image_pair(seed, shape):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, shape[-2]), np.linspace(0, 1, shape[-1]), indexing="ij")
    preds = np.clip(0.5 + 0.3 * np.sin(6 * yy + rng.rand(*shape[:-2], 1, 1)) * np.cos(4 * xx) + 0.05 * rng.randn(*shape), 0, 1)
    target = np.clip(preds + 0.05 * rng.randn(*shape), 0, 1)
    return torch.from_numpy(preds.astype(np.float32)), torch.from_numpy(target.astype(np.float32))


def _generic_launches(fn, *args, **kwargs):
    """``fn``'s value and the generic entry's launches it made (the fused
    entry must launch none)."""
    from torchmetrics_tpu_torch.ops import ssim_kernel

    kernels.reset_gate_log()
    before = ssim_kernel.launches
    value = fn(*args, **kwargs)
    torch.cuda.synchronize()
    gate = kernels.gate_snapshot()
    assert "ssim_fused" not in gate and gate["ssim_windows"]["selections"] == {"cuda": ssim_kernel.launches - before}
    return value, ssim_kernel.launches - before


@pytest.mark.parametrize(
    "name, kwargs, launches, rtol",
    [
        ("universal_image_quality_index", {}, 1, 1e-4),
        ("root_mean_squared_error_using_sliding_window", {"window_size": 8}, 1, 1e-5),
        ("relative_average_spectral_error", {"window_size": 7}, 2, 1e-5),
        ("spatial_correlation_coefficient", {"window_size": 8}, 15, 1e-4),
        ("visual_information_fidelity", {}, 78, 1e-4),
        ("spectral_distortion_index", {}, 2, 1e-4),
    ],
)
def test_rest_of_image_on_card_equals_cpu(cuda_device, name, kwargs, launches, rtol):
    """Each metric that windows on ``ssim_windows``: the card's value (every
    window one generic launch) against the CPU's plain bodies."""
    from torchmetrics_tpu_torch import functional as F_

    preds, target = _image_pair(1, (2, 3, 64, 70))
    fn = getattr(F_, name)
    got, n = _generic_launches(fn, preds.to(cuda_device), target.to(cuda_device), **kwargs)
    assert n == launches
    torch.testing.assert_close(got.cpu(), fn(preds, target, **kwargs), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("with_lr", [False, True])
def test_pansharpening_on_card_equals_cpu(cuda_device, with_lr):
    """D_s (two UQI launches a band, and one for the pan image's low-pass
    unless ``pan_lr`` is given) and QNR (D_lambda's two more) on the card
    against the CPU."""
    from torchmetrics_tpu_torch.functional import quality_with_no_reference, spatial_distortion_index

    preds, pan = _image_pair(2, (2, 4, 64, 64))
    ms = preds[:, :, ::4, ::4].contiguous() * 0.9
    pan_lr = pan[:, :, ::4, ::4].contiguous() if with_lr else None
    args = (preds, ms, pan, pan_lr)
    on_card = [a if a is None else a.to(cuda_device) for a in args]
    d_s, n = _generic_launches(spatial_distortion_index, *on_card)
    assert n == 2 * 4 + (0 if with_lr else 1)
    qnr, n = _generic_launches(quality_with_no_reference, *on_card)
    assert n == 2 + 2 * 4 + (0 if with_lr else 1)
    torch.testing.assert_close(d_s.cpu(), spatial_distortion_index(*args), rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(qnr.cpu(), quality_with_no_reference(*args), rtol=1e-4, atol=1e-6)


def test_vif_gradient_on_card_equals_cpu(cuda_device):
    from torchmetrics_tpu_torch.functional import visual_information_fidelity

    preds, target = _image_pair(3, (1, 2, 48, 52))
    p_card, p_cpu = preds.to(cuda_device).requires_grad_(), preds.clone().requires_grad_()
    visual_information_fidelity(p_card, target.to(cuda_device)).backward()
    visual_information_fidelity(p_cpu, target).backward()
    torch.testing.assert_close(p_card.grad.cpu(), p_cpu.grad, rtol=1e-3, atol=1e-8)


def test_del_frees_card_memory_without_the_cyclic_gc(cuda_device):
    """With the cyclic garbage collector off, ``del`` of an updated metric
    and of a collection gives their card memory back at once."""
    import gc

    was_enabled = gc.isenabled()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    gc.disable()
    try:
        coll = tm.MetricCollection(
            {"confmat": MulticlassConfusionMatrix(num_classes=2048, device=cuda_device),
             "acc": MulticlassAccuracy(num_classes=2048, device=cuda_device)},
            device=cuda_device,
        )
        coll.update(torch.randint(0, 2048, (4096,), device=cuda_device), torch.randint(0, 2048, (4096,), device=cuda_device))
        coll.compute()
        assert torch.cuda.memory_allocated(cuda_device) > base + 2048 * 2048 * 4
        del coll
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda_device) == base
    finally:
        if was_enabled:
            gc.enable()


# ------------------------------------------------- regression and pairwise
#
# No kernel of the port runs on these paths: plain PyTorch on the card,
# held to the same path on the CPU (rtol 1e-5: float32 sums in another
# order), to float64 and to scipy.

REGRESSION_ON_CARD = [
    ("MeanAbsoluteError", {}, (4096,)),
    ("MeanSquaredError", {"num_outputs": 3, "squared": False}, (4096, 3)),
    ("MeanSquaredLogError", {}, (4096,)),
    ("MeanAbsolutePercentageError", {}, (4096,)),
    ("SymmetricMeanAbsolutePercentageError", {}, (4096,)),
    ("WeightedMeanAbsolutePercentageError", {}, (4096,)),
    ("RelativeSquaredError", {"num_outputs": 3}, (4096, 3)),
    ("LogCoshError", {"num_outputs": 3}, (4096, 3)),
    ("MinkowskiDistance", {"p": 3}, (4096,)),
    ("TweedieDevianceScore", {"power": 1.5}, (4096,)),
    ("CriticalSuccessIndex", {"threshold": 1.5}, (4096,)),
    ("CriticalSuccessIndex", {"threshold": 1.5, "keep_sequence_dim": 1}, (64, 8, 32)),
    ("PearsonCorrCoef", {"num_outputs": 3}, (4096, 3)),
    ("ConcordanceCorrCoef", {}, (4096,)),
    ("SpearmanCorrCoef", {}, (4096,)),
    ("KendallRankCorrCoef", {"variant": "c", "t_test": True}, (2048,)),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, (4096, 3)),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, (4096, 3)),
    ("CosineSimilarity", {"reduction": "mean"}, (512, 16)),
    ("KLDivergence", {}, (512, 16)),
]


def _launch_counts():
    from torchmetrics_tpu_torch.ops import binned_curve, sqrtm_kernel, ssim_kernel, topk_kernel

    return [m.launches for m in (bincount, binned_curve, topk_kernel, ssim_kernel, sqrtm_kernel)]


@pytest.mark.parametrize("name,kwargs,shape", REGRESSION_ON_CARD, ids=lambda v: v if isinstance(v, str) else None)
def test_regression_class_on_card_equals_cpu(cuda_device, name, kwargs, shape):
    from torchmetrics_tpu_torch import regression

    rng = np.random.RandomState(len(name))
    batches = []
    for _ in range(3):
        target = rng.uniform(0.5, 3.0, shape).astype(np.float32)
        batches.append((target * rng.uniform(0.8, 1.2, shape).astype(np.float32), target))
    card = getattr(regression, name)(device=cuda_device, **kwargs)
    cpu = getattr(regression, name)(device="cpu", **kwargs)
    before = _launch_counts()
    for p, t in batches:
        card.update(torch.from_numpy(p).to(cuda_device), torch.from_numpy(t).to(cuda_device))
        cpu.update(torch.from_numpy(p), torch.from_numpy(t))
    got, want = card.compute(), cpu.compute()
    assert _launch_counts() == before
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)


def test_pearson_count_is_exact_past_2_24_on_card(cuda_device):
    """2**24 + 3 samples in 17 updates: the count is exact (int64) and the
    correlation is float64's within 1e-5."""
    from torchmetrics_tpu_torch.regression import PearsonCorrCoef

    g = torch.Generator(device=cuda_device).manual_seed(0)
    m = PearsonCorrCoef(device=cuda_device)
    n, sx, sy, sxx, syy, sxy = 0, 0.0, 0.0, 0.0, 0.0, 0.0
    sizes = [1 << 20] * 16 + [3]
    for size in sizes:
        x = torch.randn(size, generator=g, device=cuda_device)
        y = 0.6 * x + 0.8 * torch.randn(size, generator=g, device=cuda_device) + 5.0
        m.update(x, y)
        x64, y64 = x.double(), y.double()
        n += size
        sx, sy = sx + float(x64.sum()), sy + float(y64.sum())
        sxx, syy, sxy = sxx + float((x64 * x64).sum()), syy + float((y64 * y64).sum()), sxy + float((x64 * y64).sum())
    assert m.n_total.dtype == torch.int64 and int(m.n_total) == 2**24 + 3
    r64 = (n * sxy - sx * sy) / np.sqrt((n * sxx - sx * sx) * (n * syy - sy * sy))
    assert abs(float(m.compute()) - r64) <= 1e-5


@pytest.mark.parametrize("variant", ["b", "c"])
def test_tiled_kendall_on_card_equals_scipy(cuda_device, variant, monkeypatch):
    """n = 5,000 with ties, in tiles of 16 rows: tau within 1e-6 of scipy."""
    from scipy.stats import kendalltau

    from torchmetrics_tpu_torch.functional import kendall_rank_corrcoef
    from torchmetrics_tpu_torch.functional.regression import rank_based

    rng = np.random.RandomState(1)
    x = np.round(rng.randn(5000), 1).astype(np.float32)
    y = np.round(0.7 * x + 0.5 * rng.randn(5000), 1).astype(np.float32)
    monkeypatch.setattr(rank_based, "_KENDALL_TILE_PAIRS", 16 * 5000)
    got = kendall_rank_corrcoef(torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device), variant=variant)
    want = kendalltau(x.astype(np.float64), y.astype(np.float64), variant=variant).statistic
    assert abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize("name", ["pairwise_manhattan_distance", "pairwise_minkowski_distance"])
def test_chunked_pairwise_on_card_equals_float64(cuda_device, name, monkeypatch):
    """1,000 x 700 rows of 96 features in chunks of 9 rows: within rtol 1e-5
    of float64 ``torch.cdist``."""
    from torchmetrics_tpu_torch import functional
    from torchmetrics_tpu_torch.functional.pairwise import distances

    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(1000, 96, generator=g, device=cuda_device)
    y = torch.randn(700, 96, generator=g, device=cuda_device)
    monkeypatch.setattr(distances, "_CHUNK_ELEMENTS", 9 * 700 * 96)
    p = 1.0 if name == "pairwise_manhattan_distance" else 3.0
    got = getattr(functional, name)(x, y) if p == 1.0 else getattr(functional, name)(x, y, exponent=p)
    want = torch.cdist(x.double(), y.double(), p=p)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize(
    "name", ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity"]
)
def test_pairwise_products_stay_full_float32_under_global_tf32(cuda_device, name):
    """With TF32 turned on globally, the products still run in full float32
    (within 1e-5 of float64, where TF32's ten mantissa bits miss by about
    1e-3), and the caller's setting is left as it was."""
    from torchmetrics_tpu_torch import functional

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(512, 256, generator=g, device=cuda_device) + 3.0
    y = torch.randn(384, 256, generator=g, device=cuda_device) + 3.0
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = getattr(functional, name)(x, y)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    x64, y64 = x.double(), y.double()
    if name == "pairwise_linear_similarity":
        want = x64 @ y64.T
    elif name == "pairwise_cosine_similarity":
        want = (x64 / x64.norm(dim=1, keepdim=True)) @ (y64 / y64.norm(dim=1, keepdim=True)).T
    else:
        want = torch.cdist(x64, y64)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def _host_copies(monkeypatch):
    """Record the element count of every tensor the code under test moves
    from the card to the host (``cpu``, ``numpy``, ``tolist``, ``item`` and
    ``to`` a CPU device)."""
    seen = []
    for name in ("cpu", "numpy", "tolist", "item"):
        original = getattr(torch.Tensor, name)

        def patched(self, *args, __original=original, **kwargs):
            if self.is_cuda:
                seen.append(self.numel())
            return __original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, patched)
    original_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        out = original_to(self, *args, **kwargs)
        if self.is_cuda and not out.is_cuda:
            seen.append(self.numel())
        return out

    monkeypatch.setattr(torch.Tensor, "to", to)
    return seen


def test_bootstrapper_indexes_the_batch_on_the_card(cuda_device, monkeypatch):
    """Each replicate's resample is indexed on the card (its indices are the
    only host-to-device copy), no batch is read back, and every replicate's
    counts equal the same seed's on the CPU bit for bit."""
    rng = np.random.RandomState(0)
    batches = [(rng.rand(n, 50).astype(np.float32), rng.randint(0, 50, n)) for n in (256, 31)]
    boot = {
        dev: tm.BootStrapper(MulticlassAccuracy(50, average="macro", validate_args=False, device=dev), num_bootstraps=5, seed=7)
        for dev in ("cpu", cuda_device)
    }
    for preds, target in batches:
        boot["cpu"].update(torch.as_tensor(preds), torch.as_tensor(target))
    launched = bincount.launches
    seen = _host_copies(monkeypatch)
    for preds, target in batches:
        boot[cuda_device].update(torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device))
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert all(n < 31 for n in seen), seen
    assert bincount.launches - launched == sum(m.update_count for m in boot[cuda_device].metrics)
    for a, b in zip(boot["cpu"].metrics, boot[cuda_device].metrics):
        for k in a._defaults:
            assert torch.equal(a.metric_state[k], b.metric_state[k].cpu())


def test_multioutput_drops_nan_rows_on_the_card(cuda_device, monkeypatch):
    from torchmetrics_tpu_torch.regression import MeanSquaredError

    rng = np.random.RandomState(1)
    preds, target = rng.rand(500, 8).astype(np.float32), rng.rand(500, 8).astype(np.float32)
    target[rng.rand(500, 8) < 0.2] = np.nan
    cpu = tm.MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=8)
    card = tm.MultioutputWrapper(MeanSquaredError(device=cuda_device), num_outputs=8)
    cpu.update(torch.as_tensor(preds), torch.as_tensor(target))
    seen = _host_copies(monkeypatch)
    card.update(torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device))
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert all(n < 500 for n in seen), seen
    torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=1e-5, atol=0.0)


def test_nominal_state_is_an_exact_int64_count_on_the_card(cuda_device):
    rng = np.random.RandomState(2)
    x, y = rng.randint(0, 7, 100_000), rng.randint(0, 7, 100_000)
    cpu, card = tm.TheilsU(7, device="cpu"), tm.TheilsU(7, device=cuda_device)
    launched = bincount.launches
    for _ in range(2):
        cpu.update(torch.as_tensor(x), torch.as_tensor(y))
        card.update(torch.as_tensor(x, device=cuda_device), torch.as_tensor(y, device=cuda_device))
    assert bincount.launches - launched == 2
    assert card.confmat.dtype == torch.int64 and card.confmat.is_cuda
    assert torch.equal(card.confmat.cpu(), cpu.confmat)
    torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=1e-5, atol=1e-6)
    card.load_state({"confmat": torch.full((7, 7), 2**24, dtype=torch.int64, device=cuda_device)})
    card.update(torch.as_tensor(x, device=cuda_device), torch.as_tensor(y, device=cuda_device))
    assert int(card.confmat.sum()) == 49 * 2**24 + 100_000


def test_nominal_functionals_on_the_card_equal_the_cpu(cuda_device):
    from torchmetrics_tpu_torch import functional

    rng = np.random.RandomState(3)
    matrix = rng.randint(0, 5, (20_000, 4)) * 3 + 1  # non-contiguous labels
    matrix[:, 1] = np.where(rng.rand(20_000) < 0.5, matrix[:, 0], matrix[:, 1])
    launched = bincount.launches
    for name in ("cramers_v_matrix", "tschuprows_t_matrix", "pearsons_contingency_coefficient_matrix", "theils_u_matrix"):
        got = getattr(functional, name)(torch.as_tensor(matrix, device=cuda_device))
        want = getattr(functional, name)(torch.as_tensor(matrix))
        torch.testing.assert_close(got.cpu(), want, rtol=0.0, atol=1e-5)
    assert bincount.launches - launched == 6 * 3 + 12


# ---------------------------------------------------------------------- text


def test_text_native_library_is_built_and_loaded(cuda_device):
    from torchmetrics_tpu_torch import native

    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build" and path.name.startswith("libtm_text_native-")
    pairs = [("a b c d".split(), "a c d e".split()), (list("kitten"), list("sitting"))]
    assert native.batch_edit_distance(pairs).tolist() == [native._py_edit_distance(a, b) for a, b in pairs]


def _ppl_inputs(seed, ignore_index):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(4, 64, 1000) * 2).astype(np.float32))
    target = torch.from_numpy(rng.randint(0, 1000, (4, 64)))
    if ignore_index is not None:
        target[torch.from_numpy(rng.rand(4, 64) < 0.3)] = ignore_index
    return logits, target


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_on_the_card_equals_the_cpu_and_float64(cuda_device, ignore_index):
    card, cpu = tm.Perplexity(ignore_index=ignore_index, device=cuda_device), tm.Perplexity(ignore_index=ignore_index, device="cpu")
    total64, count = 0.0, 0
    for seed in range(3):
        logits, target = _ppl_inputs(seed, ignore_index)
        card.update(logits.to(cuda_device), target.to(cuda_device))
        cpu.update(logits, target)
        mask = target != ignore_index if ignore_index is not None else torch.ones_like(target, dtype=torch.bool)
        lp = torch.log_softmax(logits.double(), -1).gather(-1, target.clamp_min(0)[..., None]).squeeze(-1)
        total64 -= float(lp[mask].sum())
        count += int(mask.sum())
    assert card.total_log_probs.is_cuda and card.count.dtype == torch.int32
    assert int(card.count) == int(cpu.count) == count
    torch.testing.assert_close(card.total_log_probs.cpu(), cpu.total_log_probs, rtol=1e-5, atol=0.0)
    assert float(card.compute()) == pytest.approx(np.exp(total64 / count), rel=1e-5)


def test_perplexity_out_of_range_target_is_nan_and_the_context_lives(cuda_device):
    logits, target = _ppl_inputs(4, None)
    target[1, 3], target[2, 5] = 1000, -7
    value = tm.functional.perplexity(logits.to(cuda_device), target.to(cuda_device))
    assert torch.isnan(value).item()
    assert int(torch.arange(5, device=cuda_device).sum()) == 10
    torch.cuda.synchronize()


def _card_embedder(device):
    table = torch.randn(500, 32, generator=torch.Generator().manual_seed(0))

    def embed(sentences):
        width = max(len(s.split()) for s in sentences)
        ids = torch.zeros(len(sentences), width, dtype=torch.int64)
        mask = torch.zeros(len(sentences), width, dtype=torch.bool)
        for i, s in enumerate(sentences):
            for j, w in enumerate(s.split()):
                ids[i, j] = sum(map(ord, w)) % 500
                mask[i, j] = True
        return table[ids].to(device), mask.to(device), ids.to(device)

    return embed


def test_bertscore_with_card_tensors_equals_the_cpu(cuda_device):
    preds = ["the cat sat on the mat", "a dog ran", "over the house"]
    target = ["a cat sat on a mat", "the dog ran far", "house"]
    card = tm.BERTScore(user_model=_card_embedder(cuda_device), idf=True, device=cuda_device)
    card.update(preds, target)
    got = card.compute()
    want = tm.functional.bert_score(preds, target, user_model=_card_embedder("cpu"), idf=True, device="cpu")
    for k in ("precision", "recall", "f1"):
        assert got[k].is_cuda
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="never copied"):
        tm.functional.bert_score(preds, target, user_model=_card_embedder("cpu"), device=cuda_device)


@pytest.mark.parametrize(
    "measure,kwargs",
    [("kl_divergence", {}), ("alpha_divergence", {"alpha": 0.5}), ("beta_divergence", {"beta": 0.5}),
     ("ab_divergence", {"alpha": 0.5, "beta": 0.5}), ("renyi_divergence", {"alpha": 0.5}), ("l1_distance", {}),
     ("l2_distance", {}), ("l_infinity_distance", {}), ("fisher_rao_distance", {})],
)
def test_infolm_with_card_tensors_equals_the_cpu(cuda_device, measure, kwargs):
    def mlm(device):
        def dist(sentences):
            g = torch.Generator().manual_seed(len("".join(sentences)))
            d = torch.rand(len(sentences), 300, generator=g) ** 4 + 1e-4
            return (d / d.sum(1, keepdim=True)).to(device)

        return dist

    preds, target = ["the cat sat", "a dog ran"], ["a cat sat down", "the dog"]
    got = tm.functional.infolm(preds, target, information_measure=measure, user_model=mlm(cuda_device), device=cuda_device,
                               return_sentence_level_score=True, **kwargs)
    want = tm.functional.infolm(preds, target, information_measure=measure, user_model=mlm("cpu"), device="cpu",
                                return_sentence_level_score=True, **kwargs)
    assert got[1].is_cuda
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-6)


def test_text_class_state_stays_on_the_card(cuda_device):
    preds, target = ["the cat sat on the mat", "a dog ran"], ["a cat sat on the mat", "the dog ran far"]
    metrics = {
        "wer": tm.WordErrorRate(device=cuda_device), "bleu": tm.BLEUScore(device=cuda_device),
        "chrf": tm.CHRFScore(return_sentence_level_score=True, device=cuda_device),
        "ter": tm.TranslationEditRate(return_sentence_level_score=True, device=cuda_device),
        "eed": tm.ExtendedEditDistance(device=cuda_device), "rouge": tm.ROUGEScore(device=cuda_device),
        "edit": tm.EditDistance(reduction="none", device=cuda_device),
    }
    for m in metrics.values():
        m.update(preds, target)
        for value in m.metric_state.values():
            for t in value if isinstance(value, list) else [value]:
                assert t.is_cuda, (type(m).__name__, t.device)
    squad = tm.SQuAD(device=cuda_device)
    squad.update([{"prediction_text": "a cat", "id": "1"}], [{"answers": {"text": ["the cat"]}, "id": "1"}])
    assert all(v.is_cuda for v in squad.metric_state.values())
    for m in [*metrics.values(), squad]:
        out = m.compute()
        values = out.values() if isinstance(out, dict) else (out if isinstance(out, tuple) else [out])
        assert all(v.is_cuda for v in values)
    assert tm.functional.word_error_rate(preds, target).device == cuda_device


# --------------------------------------------------------------------- audio


def _speech_batch(fs, seconds, count, seed):
    """Speech-shaped float32 signals from the fixture clips (decimated to
    ``fs``), shifted and scaled, and a noised, echoed estimate of each."""
    from pathlib import Path

    speech = np.load(Path(__file__).resolve().parent / "fixtures_real" / "speech.npz")
    rng = np.random.RandomState(seed)
    n = int(seconds * fs)
    clean = []
    for k in range(count):
        clip = speech["clip1" if k % 2 == 0 else "clip2"].astype(np.float64)[:: 16000 // fs]
        tiled = np.tile(clip, n // len(clip) + 2)
        shift = rng.randint(0, len(clip))
        clean.append(rng.uniform(0.5, 1.5) * tiled[shift : shift + n])
    clean = np.stack(clean)
    noisy = clean + 0.3 * np.roll(clean, 7, axis=-1) + 0.05 * np.abs(clean).max() * rng.randn(*clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def _audio_calls():
    from torchmetrics_tpu_torch import functional as fn

    return [
        ("sdr", lambda p, t: fn.signal_distortion_ratio(p.double(), t.double(), filter_length=128), 1e-9),
        ("si_sdr", fn.scale_invariant_signal_distortion_ratio, 1e-5),
        ("sa_sdr", lambda p, t: fn.source_aggregated_signal_distortion_ratio(p.reshape(2, 2, -1), t.reshape(2, 2, -1)), 1e-5),
        ("snr", fn.signal_noise_ratio, 1e-5),
        ("si_snr", fn.scale_invariant_signal_noise_ratio, 1e-5),
        ("c_si_snr", lambda p, t: fn.complex_scale_invariant_signal_noise_ratio(p.reshape(4, 40, -1, 2), t.reshape(4, 40, -1, 2)), 1e-5),
        ("pit_speaker_wise", lambda p, t: fn.permutation_invariant_training(p.reshape(2, 2, -1), t.reshape(2, 2, -1).flip(1), fn.scale_invariant_signal_distortion_ratio), 1e-5),
        ("pit_permutation_wise", lambda p, t: fn.permutation_invariant_training(p.reshape(2, 2, -1), t.reshape(2, 2, -1), fn.source_aggregated_signal_distortion_ratio, mode="permutation-wise"), 1e-5),
        ("pesq", lambda p, t: fn.perceptual_evaluation_speech_quality(p, t, 8000, "nb"), 0.0),
        ("stoi_host", lambda p, t: fn.short_time_objective_intelligibility(p, t, 8000), 0.0),
        ("srmr_host", lambda p, t: fn.speech_reverberation_modulation_energy_ratio(p, 8000), 0.0),
    ]


@pytest.mark.parametrize("case", range(11))
def test_audio_functional_on_the_card_equals_the_cpu(cuda_device, case):
    name, call, rtol = _audio_calls()[case]
    preds, target = _speech_batch(8000, 1.6, 4, seed=case)
    got = call(torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device))
    want = call(torch.as_tensor(preds), torch.as_tensor(target))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.device == cuda_device, name
        torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=1e-4 if rtol else 0.0)


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("extended", [False, True])
def test_stoi_on_device_on_the_card(cuda_device, fs, extended):
    from torchmetrics_tpu_torch import functional as fn

    preds, target = _speech_batch(fs, 2.0, 3, seed=fs)
    got = fn.short_time_objective_intelligibility(
        torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device), fs, extended, on_device=True
    )
    assert got.device == cuda_device and got.dtype == torch.float32 and got.shape == (3,)
    cpu = fn.short_time_objective_intelligibility(torch.as_tensor(preds), torch.as_tensor(target), fs, extended, on_device=True)
    host = fn.short_time_objective_intelligibility(torch.as_tensor(preds), torch.as_tensor(target), fs, extended)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(got.cpu(), host, rtol=0.0, atol=2e-3)


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("norm", [False, True])
def test_srmr_on_device_on_the_card(cuda_device, fs, norm, monkeypatch):
    from torchmetrics_tpu_torch import functional as fn
    from torchmetrics_tpu_torch.functional.audio import srmr

    _, clean = _speech_batch(fs, 2.0, 3, seed=fs + 1)
    x = torch.as_tensor(clean, device=cuda_device)
    got = fn.speech_reverberation_modulation_energy_ratio(x, fs, norm=norm, on_device=True)
    assert got.device == cuda_device and got.dtype == torch.float32 and got.shape == (3,)
    cpu = fn.speech_reverberation_modulation_energy_ratio(x.cpu(), fs, norm=norm, on_device=True)
    host = fn.speech_reverberation_modulation_energy_ratio(x.cpu(), fs, norm=norm)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.cpu(), host, rtol=1e-3, atol=0.0)
    monkeypatch.setattr(srmr, "DEVICE_BUDGET_BYTES", 1)  # one signal a chunk
    torch.testing.assert_close(fn.speech_reverberation_modulation_energy_ratio(x, fs, norm=norm, on_device=True), got, rtol=1e-6, atol=0.0)


def test_audio_class_state_stays_on_the_card(cuda_device):
    preds, target = _speech_batch(8000, 1.6, 4, seed=9)
    p, t = torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device)
    for metric in (tm.SignalDistortionRatio(filter_length=64), tm.ShortTimeObjectiveIntelligibility(8000, on_device=True),
                   tm.PerceptualEvaluationSpeechQuality(8000, "nb")):
        metric.update(p, t)
        assert metric.total.device == cuda_device and metric.total.dtype == torch.int64 and int(metric.total) == 4
        assert metric.compute().device == cuda_device
    with pytest.raises(RuntimeError, match="never"):
        tm.SignalNoiseRatio().update(p.cpu(), t.cpu())


# ---------------------------------------------------------------- clustering


def test_clustering_contingency_is_one_bincount_launch_on_the_card(cuda_device):
    from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix

    rng = np.random.RandomState(4)
    target = rng.randint(0, 1000, 50_000)
    preds = np.where(rng.rand(50_000) < 0.2, rng.randint(0, 1000, 50_000), target)
    p, t = torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device)
    kernels.reset_gate_log()
    launched = bincount.launches
    got = calculate_contingency_matrix(p, t)
    torch.cuda.synchronize()
    assert bincount.launches - launched == 1
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"cuda": 1}
    assert got.is_cuda and got.dtype == torch.int64 and got.shape == (1000, 1000)
    assert torch.equal(got.cpu(), calculate_contingency_matrix(p.cpu(), t.cpu()))


def test_clustering_functionals_on_the_card_equal_the_cpu(cuda_device):
    from torchmetrics_tpu_torch import functional as fn

    rng = np.random.RandomState(5)
    target = rng.randint(0, 40, 5_000) * 3 + 7
    preds = np.where(rng.rand(5_000) < 0.3, rng.randint(0, 45, 5_000), target)
    data = (rng.randn(40, 16)[(target - 7) // 3] + 0.5 * rng.randn(5_000, 16)).astype(np.float32)
    launched = bincount.launches
    for name in ("mutual_info_score", "normalized_mutual_info_score", "adjusted_mutual_info_score", "rand_score",
                 "adjusted_rand_score", "fowlkes_mallows_index", "homogeneity_score", "completeness_score", "v_measure_score"):
        got = getattr(fn, name)(torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device))
        want = getattr(fn, name)(torch.as_tensor(preds), torch.as_tensor(target))
        assert got.device == cuda_device, name
        torch.testing.assert_close(got.cpu(), want, rtol=0.0, atol=1e-5)
    assert bincount.launches - launched == 4 + 5 * 3
    for name in ("calinski_harabasz_score", "davies_bouldin_score", "dunn_index"):
        got = getattr(fn, name)(torch.as_tensor(data, device=cuda_device), torch.as_tensor(target, device=cuda_device))
        want = getattr(fn, name)(torch.as_tensor(data), torch.as_tensor(target))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0.0)


# ------------------------------------------- detection, segmentation, multimodal


def _to(items, device):
    return [{k: torch.as_tensor(np.asarray(v), device=device) for k, v in d.items()} for d in items]


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_mean_ap_on_the_card_equals_the_cpu(cuda_device, iou_type, monkeypatch):
    """The summary dict on the card equals the CPU's within 1e-6, for one
    chunk of pairs and for chunks of one pair; the states stay on the card."""
    from test_torch_mean_ap import crowded, segm_batch
    from torchmetrics_tpu_torch.detection import mean_ap

    batches = [crowded(s, images=12) for s in range(3)] if iou_type == "bbox" else [segm_batch(s) for s in range(3)]
    for budget in (mean_ap.MATCH_BUDGET_BYTES, 1):
        monkeypatch.setattr(mean_ap, "MATCH_BUDGET_BYTES", budget)
        card = tm.MeanAveragePrecision(iou_type=iou_type, class_metrics=True)
        cpu = tm.MeanAveragePrecision(iou_type=iou_type, class_metrics=True, device="cpu")
        for preds, target in batches:
            card.update(_to(preds, cuda_device), _to(target, cuda_device))
            cpu.update(_to(preds, "cpu"), _to(target, "cpu"))
        assert all(d.is_cuda for d in card.detections)
        got, want = card.compute(), cpu.compute()
        for k in want:
            assert got[k].device == cuda_device, k
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=0.0, atol=1e-6)


def test_panoptic_quality_takes_one_bincount_launch_an_update_on_the_card(cuda_device):
    from test_torch_panoptic import STUFFS, THINGS, panoptic_maps

    card = tm.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=True, return_per_class=True, return_sq_and_rq=True)
    cpu = tm.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=True, return_per_class=True, return_sq_and_rq=True, device="cpu")
    kernels.reset_gate_log()
    launched = bincount.launches
    for seed in range(4):
        preds, target = panoptic_maps(seed, batch=3, spatial=(48, 40))
        card.update(torch.as_tensor(preds, device=cuda_device), torch.as_tensor(target, device=cuda_device))
        cpu.update(torch.as_tensor(preds), torch.as_tensor(target))
    torch.cuda.synchronize()
    assert bincount.launches - launched == 4
    assert kernels.gate_snapshot()["bincount"]["selections"] == {"cuda": 4, "reference": 4}
    for k in ("true_positives", "false_positives", "false_negatives"):
        assert torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
    torch.testing.assert_close(card.iou_sum.cpu(), cpu.iou_sum, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("metric", ["euclidean", "chessboard", "taxicab"])
def test_chunked_distance_transform_on_the_card_equals_one_chunk(cuda_device, metric, monkeypatch):
    from torchmetrics_tpu_torch.functional.segmentation import utils

    rng = np.random.RandomState(6)
    x = torch.as_tensor(rng.rand(240, 240) > 0.02, device=cuda_device)
    whole = utils.distance_transform(x, sampling=[1.0, 1.5], metric=metric)
    monkeypatch.setattr(utils, "DISTANCE_BUDGET_BYTES", 1 << 20)
    assert torch.equal(utils.distance_transform(x, sampling=[1.0, 1.5], metric=metric), whole)
    cpu = utils.distance_transform(x.cpu(), sampling=[1.0, 1.5], metric=metric)
    torch.testing.assert_close(whole.cpu(), cpu, rtol=1e-6, atol=1e-6)


def test_segmentation_and_iou_on_the_card_equal_the_cpu(cuda_device):
    from test_torch_mean_ap import crowded
    from torchmetrics_tpu_torch.functional.segmentation import utils

    rng = np.random.RandomState(7)
    vol = torch.as_tensor(rng.rand(2, 40, 36, 30) > 0.5, device=cuda_device)
    for spacing in (None, (1, 1, 1)):
        got = utils.mask_edges(vol[0], vol[1], spacing=spacing)
        want = utils.mask_edges(vol[0].cpu(), vol[1].cpu(), spacing=spacing)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    preds, target = crowded(3, images=10)
    for cls in ("IntersectionOverUnion", "CompleteIntersectionOverUnion"):
        card, cpu = getattr(tm, cls)(class_metrics=True), getattr(tm, cls)(class_metrics=True, device="cpu")
        card.update(_to(preds, cuda_device), _to(target, cuda_device))
        cpu.update(_to(preds, "cpu"), _to(target, "cpu"))
        got, want = card.compute(), cpu.compute()
        for k in want:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6, atol=1e-6, equal_nan=True)


def test_clip_scores_on_the_card_equal_the_cpu(cuda_device):
    w = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))

    def embed(images, texts):
        feats = images.mean(dim=(2, 3)) @ w.to(images.device)
        return feats, torch.stack([torch.full((16,), float(len(t)), device=images.device).cos() + feats[i] for i, t in enumerate(texts)])

    imgs = torch.rand(6, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    texts = [f"caption {'x' * i}" for i in range(6)]
    card, cpu = tm.CLIPScore(embedding_fn=embed), tm.CLIPScore(embedding_fn=embed, device="cpu")
    card.update(imgs.to(cuda_device), texts)
    cpu.update(imgs, texts)
    assert card.score.is_cuda
    torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=1e-5, atol=1e-5)
    iqa = tm.CLIPImageQualityAssessment(lambda x: x.mean(dim=(2, 3)) @ w.to(x.device),
                                        lambda p: torch.randn(len(p), 16, generator=torch.Generator().manual_seed(2)),
                                        prompts=("quality", "sharpness"))
    iqa.update(imgs.to(cuda_device))
    ref = tm.CLIPImageQualityAssessment(lambda x: x.mean(dim=(2, 3)) @ w,
                                        lambda p: torch.randn(len(p), 16, generator=torch.Generator().manual_seed(2)),
                                        prompts=("quality", "sharpness"), device="cpu")
    ref.update(imgs)
    for k, v in ref.compute().items():
        torch.testing.assert_close(iqa.compute()[k].cpu(), v, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ runtime layers
# Reads, autosaves and device timing on the card's streams: the worker
# threads run on the default stream, so each waits on an event recorded on
# the caller's stream before it reads (ops/async_read.py).


def _runtime_collection(device):
    c = 100
    return tm.MetricCollection(
        {
            "accuracy": MulticlassAccuracy(num_classes=c, average="micro", validate_args=False),
            "f1": MulticlassF1Score(num_classes=c, validate_args=False),
            "confmat": MulticlassConfusionMatrix(num_classes=c, validate_args=False),
        },
        device=device,
    )


def _runtime_batches(device, n=12, seed=16):
    g = torch.Generator(device=device).manual_seed(seed)
    return [
        (torch.randn(1 << 16, 100, generator=g, device=device), torch.randint(0, 100, (1 << 16,), generator=g, device=device))
        for _ in range(n)
    ]


def _assert_bit_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_compute_async_on_a_side_stream_equals_compute(cuda_device):
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline

    batches = _runtime_batches(cuda_device)
    ref, blocking = _runtime_collection(cuda_device), {}
    for i, batch in enumerate(batches, 1):
        ref.update(*batch)
        blocking[i] = ref.compute()
    coll, futures = _runtime_collection(cuda_device), {}
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        for i, batch in enumerate(batches, 1):
            coll.update(*batch)
            futures[i] = coll.compute_async()
    for i, fut in futures.items():
        _assert_bit_equal(fut.result(60.0), blocking[i])
    assert drain_pipeline(60.0)


def test_autosave_on_a_side_stream_snapshots_exactly_its_count(cuda_device, tmp_path):
    """Every background snapshot taken while the loop runs on a side stream,
    restored and replayed from its count, ends bit-equal to the
    uninterrupted run: no save read its state before the update wrote it."""
    from torchmetrics_tpu_torch.io import Autosaver, load_manifest, restore_state
    from torchmetrics_tpu_torch.io.checkpoint import _list_snapshots

    batches = _runtime_batches(cuda_device, seed=17)
    whole = _runtime_collection(cuda_device)
    for batch in batches:
        whole.update(*batch)
    want = whole.compute()
    coll = _runtime_collection(cuda_device)
    saver = Autosaver(coll, str(tmp_path), every_n_updates=1, keep=len(batches)).attach()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    try:
        with torch.cuda.stream(stream):
            for batch in batches:
                coll.update(*batch)
        saver.flush(60.0)
    finally:
        saver.detach()
    snaps = _list_snapshots(str(tmp_path))
    assert snaps and saver.stats["saves"] == len(snaps) and saver.stats["save_errors"] == 0
    for _, path in snaps:
        count = load_manifest(path)["update_count"]
        resumed = _runtime_collection(cuda_device)
        restore_state(path, resumed)
        for batch in batches[count:]:
            resumed.update(*batch)
        _assert_bit_equal(resumed.compute(), want)


def test_observe_ready_times_a_cuda_event(cuda_device):
    from torchmetrics_tpu_torch import obs

    obs.set_tracing(True)
    obs.reset_ring()
    try:
        x = torch.randn(4096, 4096, device=cuda_device)
        y = x @ x
        assert obs.observe_ready("tm_tpu.test.matmul", y) is y
        assert obs.flush_ready_observations(30.0)
        events = [e for e in obs.peek_events() if e.name == "tm_tpu.test.matmul"]
        assert len(events) == 1 and not (events[0].attrs or {}).get("error")
        assert events[0].t_end_ns >= events[0].t_start_ns
    finally:
        obs.set_tracing(None)
        obs.reset_ring()


def test_spans_name_the_profiler_ranges_on_the_card(cuda_device):
    coll = _runtime_collection(cuda_device)
    batch = _runtime_batches(cuda_device, n=1)[0]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
        coll.update(*batch)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert {"tm_tpu.update/MulticlassAccuracy", "tm_tpu.update/MulticlassConfusionMatrix"} <= names


# ---------------------------------------------------------------------------
# Session lanes on the card (lanes.py, ops/ingest.py): the row-folded count
# against the per-row plain count, rounds through a one-slab ring against
# the plain pack, and a laned loop on a side stream.

def _lane_members(device, c=62):
    return {
        "accuracy": MulticlassAccuracy(num_classes=c, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes=c, validate_args=False, device=device),
        "confmat": MulticlassConfusionMatrix(num_classes=c, validate_args=False, device=device),
    }


def _lane_traffic(seed=0, sessions=300, rounds=4, batch=32, c=62):
    rng = np.random.RandomState(seed)
    return [
        (f"w{s}", (rng.randn(batch, c).astype(np.float32), rng.randint(0, c, batch)))
        for _ in range(rounds)
        for s in range(sessions)
    ]


@pytest.mark.parametrize("chunk_rows", [None, 7])
def test_row_folded_count_on_card_equals_per_row_plain_count(cuda_device, monkeypatch, chunk_rows):
    from torchmetrics_tpu_torch.ops import fused_classification as fc

    c = 62
    if chunk_rows is not None:
        monkeypatch.setattr(fc, "ROW_BINS_LIMIT", chunk_rows * c * c)
    rng = np.random.RandomState(3)
    preds = torch.from_numpy(rng.randn(40, 32, c).astype(np.float32)).to(cuda_device)
    target = torch.from_numpy(rng.randint(-1, c, (40, 32))).to(cuda_device)
    before = bincount.launches
    got = fc.multiclass_confusion_counts_rows(preds, target, c, -1)
    torch.cuda.synchronize()
    assert bincount.launches - before == (1 if chunk_rows is None else -(-40 // chunk_rows))
    for r in range(40):
        p, t = preds[r].argmax(1).cpu(), target[r].cpu()
        idx = torch.where(t != -1, c * t + p, torch.full_like(t, -1)).to(torch.int32)
        want = bincount._wbincount_reference(idx, None, c * c)[0].reshape(c, c)
        assert torch.equal(got[r].cpu(), want), r


@pytest.mark.parametrize("depth", ["1", "4"])
def test_laned_rounds_through_the_slab_ring_equal_the_plain_pack(cuda_device, monkeypatch, depth):
    """Back-to-back rounds, ring depth 1 (the one pinned slab rewritten
    every round, retired by its event) against the plain pack and the CPU."""
    from torchmetrics_tpu_torch import lanes, obs
    from torchmetrics_tpu_torch.ops import ingest

    items = _lane_traffic()
    monkeypatch.setenv(ingest.RING_DEPTH_ENV, depth)
    states = {}
    for flag, device in (("1", cuda_device), ("0", cuda_device), ("1", torch.device("cpu"))):
        monkeypatch.setenv(ingest.PIPELINE_ENV, flag)
        ingest.reset_for_tests()
        obs.reset()
        coll = lanes.LanedCollection(_lane_members(device), capacity=64)
        before = bincount.launches
        assert coll.update_sessions(items) == 4
        assert ingest.drain_pipeline(timeout=60.0)
        if device.type == "cuda":
            assert bincount.launches - before == 4
        if flag == "1" and device.type == "cuda":
            assert obs.counters_snapshot().get("lanes.pipelined_rounds", 0) >= 1
        states[(flag, device.type)] = {k: {f: v.cpu() for f, v in st.items() if isinstance(v, torch.Tensor)} for k, st in coll.state().items()}
    ingest.reset_for_tests()
    ref = states[("1", "cpu")]
    for key in (("1", "cuda"), ("0", "cuda")):
        for leader in ref:
            for f in ref[leader]:
                assert torch.equal(states[key][leader][f], ref[leader][f]), (key, leader, f)


def test_laned_loop_on_a_side_stream_equals_the_default_stream(cuda_device):
    from torchmetrics_tpu_torch import lanes
    from torchmetrics_tpu_torch.ops import ingest

    items = _lane_traffic(seed=5)
    ref = lanes.LanedCollection(_lane_members(cuda_device), capacity=64)
    ref.update_sessions(items)
    coll = lanes.LanedCollection(_lane_members(cuda_device), capacity=64)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        coll.update_sessions(items)
        got = coll.compute_async().result(timeout=60.0)
        values = coll.lane_values()
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    assert ingest.drain_pipeline(timeout=60.0)
    ingest.reset_for_tests()
    want = ref.compute()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref_values = ref.lane_values()
    for sid in ("w0", "w17", "w299"):
        for name in ref_values[sid]:
            assert torch.equal(values[sid][name], ref_values[sid][name]), (sid, name)


# ---------------------------------------------------------------------------
# Streaming windows on the card (windows.py, windowed lanes): the ring on the
# card against the CPU, advances free of device syncs, the windowed laned
# round's one row-folded count, and the asynchronous read's pinned clock.

def _windowed_entry(device, window=4):
    from torchmetrics_tpu_torch.classification import BinaryAUROC

    coll = tm.MetricCollection(_lane_members(device, c=10), device=device).windowed(window, lateness=1)
    auroc = BinaryAUROC(thresholds=50, validate_args=False, device=device).windowed(window, lateness=1)
    return coll, auroc


def _windowed_steps(device, seed=7, steps=10):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        out.append((torch.randn(4096, 10, generator=g), torch.randint(0, 10, (4096,), generator=g),
                    torch.rand(4096, generator=g), torch.randint(0, 2, (4096,), generator=g)))
    return [tuple(t.to(device) for t in s) for s in out]


def _drive_windowed(coll, auroc, steps):
    for i, (preds, target, probs, labels) in enumerate(steps):
        if i % 3 == 2:
            coll.update_window(coll.clock - 1, preds, target)
            auroc.update_window(auroc.clock - 1, probs, labels)
        else:
            coll.update(preds, target)
            auroc.update(probs, labels)
        if i % 2:
            coll.advance()
            auroc.advance()


def test_windowed_update_and_advance_on_the_card_equal_the_cpu(cuda_device):
    cpu = torch.device("cpu")
    runs = {}
    for device in (cuda_device, cpu):
        coll, auroc = _windowed_entry(device)
        _drive_windowed(coll, auroc, _windowed_steps(device))
        runs[device.type] = (coll, auroc)
    (gc, ga), (cc, ca) = runs["cuda"], runs["cpu"]
    for name in cc.keys():
        for f, v in cc[name]._state.items():
            assert torch.equal(gc[name]._state[f].cpu(), v), (name, f)
    for f, v in ca._state.items():
        assert torch.equal(ga._state[f].cpu(), v), f
    assert gc["confmat"].window_head.dtype == torch.int32
    for k, v in cc.compute().items():
        torch.testing.assert_close(gc.compute()[k].cpu(), v, rtol=0, atol=1e-6)
    torch.testing.assert_close(ga.compute().cpu(), ca.compute(), rtol=0, atol=1e-6)


def test_advances_make_no_device_sync(cuda_device):
    """``advance`` (the ring's slot from the host clock) and
    ``advance_windows`` on a warm clock mirror (each lane's slot from its
    head, on the device) run under sync debug mode "error"."""
    coll, auroc = _windowed_entry(cuda_device)
    _drive_windowed(coll, auroc, _windowed_steps(cuda_device, steps=3))
    laned = tm.MetricCollection(_lane_members(cuda_device), device=cuda_device).windowed(4, lateness=1).laned(capacity=64)
    laned.update_sessions(_lane_traffic(sessions=50, rounds=1))
    laned.advance_windows()  # warms the clock mirror
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        coll.advance()
        auroc.advance(2)
        laned.advance_windows()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert laned.window_spec()["clock"] == 2 and coll.clock == auroc.clock - 1


def test_windowed_laned_round_of_3550_rows_is_one_bincount_launch(cuda_device):
    """The FEMNIST-shaped windowed round: 3,550 sessions in one round of the
    windowed entry collection, one row-folded launch, no per-row loop; its
    lanes equal the same round on the CPU."""
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.ops import ingest

    items = _lane_traffic(seed=9, sessions=3550, rounds=1)
    states = {}
    for device in (cuda_device, torch.device("cpu")):
        obs.reset()
        coll = tm.MetricCollection(_lane_members(device), device=device).windowed(4, lateness=1).laned(capacity=4096)
        before = bincount.launches
        assert coll.update_sessions(items) == 1
        assert ingest.drain_pipeline(timeout=60.0)
        if device.type == "cuda":
            assert bincount.launches - before == 1
        assert obs.counters_snapshot().get("lanes.rows_looped", 0) == 0
        states[device.type] = {f: v.cpu() for f, v in coll["confmat"]._state.items()}
    ingest.reset_for_tests()
    for f, v in states["cpu"].items():
        assert torch.equal(states["cuda"][f], v), f


def test_windowed_collection_restores_onto_the_card(cuda_device, tmp_path):
    """A windowed collection saved and restored in place: its leaves land on
    the members' device, the ring and the clock bit-equal."""
    from torchmetrics_tpu_torch.io import restore_state, save_state

    coll, auroc = _windowed_entry(cuda_device)
    _drive_windowed(coll, auroc, _windowed_steps(cuda_device, steps=5))
    save_state(coll, str(tmp_path / "win.tmsnap"))
    twin, _ = _windowed_entry(cuda_device)
    restore_state(str(tmp_path / "win.tmsnap"), twin)
    assert twin.clock == coll.clock
    for name in coll.keys():
        for f, v in coll[name]._state.items():
            assert twin[name]._state[f].device == v.device and torch.equal(twin[name]._state[f], v), (name, f)


def test_windowed_async_read_pins_its_clock_on_the_card_stream(cuda_device):
    """A read submitted at a window's close on a side stream resolves
    bit-equal to the blocking compute at that close, though later updates
    and advances ran on that stream before the worker read it."""
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline

    steps = _windowed_steps(cuda_device, seed=11, steps=8)
    coll, auroc = _windowed_entry(cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        _drive_windowed(coll, auroc, steps[:4])
        at_close = coll.compute()
        future = coll.compute_async()
        _drive_windowed(coll, auroc, steps[4:])
    got = future.result(timeout=60.0)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    assert drain_pipeline(60.0)
    _assert_bit_equal(got, at_close)


# ---------------------- class sharding, the quantized sync, the large-C count


def _route_case(seed, c=257, n=4096):
    """Class indices with ignore holes (-1), labels >= C, and pads."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(-2, c + 3, n)
    cols = rng.randint(0, c, n)
    return torch.from_numpy(rows), torch.from_numpy(cols)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_class_route_on_card_equals_cpu_with_sentinel_rows(cuda_device, shards):
    from torchmetrics_tpu_torch.parallel import class_shard as cs

    c = 257
    layout = cs.shard_layout(c, shards)
    rows, cols = _route_case(shards, c)
    stack = torch.zeros((shards, layout.shard_size, c), dtype=torch.int32)
    ones = torch.ones_like(rows, dtype=torch.int32)
    cpu = cs.route_scatter_add(stack, rows, ones, inner_idx=cols, layout=layout)
    card = cs.route_scatter_add(stack.to(cuda_device), rows.to(cuda_device), ones.to(cuda_device),
                                inner_idx=cols.to(cuda_device), layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(card.cpu(), cpu)
    assert int(cpu.sum()) == int(((rows >= 0) & (rows < c)).sum())
    assert not bool(cpu.reshape(-1, c)[c:].any())


@pytest.mark.parametrize("bits,block", [(8, 256), (16, 256), (8, 37), (16, 1000)])
def test_block_encode_on_card_equals_cpu(cuda_device, bits, block):
    from torchmetrics_tpu_torch.parallel import quantized as q

    g = torch.Generator().manual_seed(bits + block)
    x = torch.randn(10_007, generator=g) * torch.linspace(0.01, 100.0, 10_007)
    codes, scales = q.block_encode(x, bits=bits, block_size=block)
    c2, s2 = q.block_encode(x.to(cuda_device), bits=bits, block_size=block)
    assert torch.equal(c2.cpu(), codes) and torch.equal(s2.cpu(), scales)


def test_nccl_quantized_sync_in_a_world_of_one_stays_in_its_bound(nccl_world):
    from torchmetrics_tpu_torch.parallel import quantized as q

    m = tm.MeanMetric(sync_precision="quantized", sync_quant_bits=8)
    s = tm.SumMetric(sync_precision="quantized", sync_quant_bits=16)
    g = torch.Generator(device=nccl_world).manual_seed(3)
    for _ in range(4):
        x = torch.randn(1000, generator=g, device=nccl_world) * 50
        m.update(x)
        s.update(x)
    for metric, bits in ((m, 8), (s, 16)):
        state = metric.state()
        synced = metric.functional_sync(state)
        floats = [k for k in metric._defaults if state[k].is_floating_point()]
        for k in metric._defaults:
            if k not in floats:
                assert torch.equal(synced[k], state[k])
        # the float "sum" fields are encoded as ONE payload: the bound is the
        # concatenation's (a block may span two fields)
        x = np.concatenate([state[k].double().cpu().numpy().reshape(-1) for k in floats])
        got = np.concatenate([synced[k].double().cpu().numpy().reshape(-1) for k in floats])
        bound = q.reduce_error_bound(x[None], "sum", bits, 256)
        # float32 rounding of the quotient and of code x scale (see
        # tests/test_torch_quantized.py:_within)
        assert (np.abs(got - x) <= bound * (1 + 2.0**-7) + 1e-6 + np.abs(x) * 2.0**-22).all()
        async_state = metric.sync_async().result(timeout=60.0)
        metric.sync()
        blocking = metric.state()
        metric.unsync()
        assert all(torch.equal(async_state[k], blocking[k]) for k in metric._defaults)


def test_large_class_stat_scores_on_card_equal_cpu(cuda_device, monkeypatch):
    """Past the C x C count's limit (lowered here) the 3C count: one launch
    an update on the card, bit-equal to the CPU."""
    from torchmetrics_tpu_torch.ops import fused_classification as fc

    monkeypatch.setattr(fc, "ROW_BINS_LIMIT", 10_000)
    c, n = 401, 50_000
    g = torch.Generator().manual_seed(5)
    target = torch.randint(-1, c, (n,), generator=g)
    preds = torch.randint(0, c, (n,), generator=g)
    out = {}
    for device in ("cpu", cuda_device):
        coll = tm.MetricCollection(
            {"acc": MulticlassAccuracy(num_classes=c, average="micro", ignore_index=-1, validate_args=False, device=device),
             "f1": MulticlassF1Score(num_classes=c, average=None, ignore_index=-1, validate_args=False, device=device)},
            device=device)
        before = bincount.launches
        coll.update(preds.to(device), target.to(device))
        if device != "cpu":
            torch.cuda.synchronize()
            assert bincount.launches == before + 1
        out[str(device)] = {k: v.cpu() for k, v in coll.compute().items()}
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert all(torch.equal(cpu[k], card[k]) for k in cpu)


# ------------------------------------------------------ the fingerprint fold

FP_DTYPES = ["bool", "int8", "uint8", "int16", "float16", "bfloat16", "int32", "float32", "int64", "float64"]


def _fp_leaf(dtype, n, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    if dtype == "bool":
        t = torch.rand(n, generator=g) < 0.5
    elif getattr(torch, dtype).is_floating_point:
        t = (torch.randn(n, generator=g) * 100).to(getattr(torch, dtype))
    else:
        info = torch.iinfo(getattr(torch, dtype))
        t = torch.randint(info.min, info.max, (n,), generator=g, dtype=torch.int64).to(getattr(torch, dtype))
    return t.to(device)


def _words_equal(a, b):
    return torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32).cpu())


@pytest.mark.parametrize("n", [0, 1, 3, 5, 1003, 1 << 20])
@pytest.mark.parametrize("dtype", FP_DTYPES)
def test_fingerprint_kernel_matches_plain_version(cuda_device, dtype, n):
    from torchmetrics_tpu_torch.ops import fingerprint

    leaf = _fp_leaf(dtype, n, seed=n)
    before = fingerprint.launches
    got = fingerprint.fingerprint_segments([leaf.to(cuda_device)])
    torch.cuda.synchronize()
    assert fingerprint.launches == before + 1 and got.device.type == "cuda" and got.dtype == torch.uint32
    assert _words_equal(got, fingerprint._fingerprint_reference(leaf))


def test_fingerprint_one_launch_for_a_tree_of_mixed_dtypes(cuda_device):
    from torchmetrics_tpu_torch import integrity
    from torchmetrics_tpu_torch.ops import fingerprint

    tree = {dtype: _fp_leaf(dtype, 1000 + i, seed=i, device=cuda_device) for i, dtype in enumerate(FP_DTYPES)}
    tree["list"] = [_fp_leaf("float32", 7, 1, cuda_device), _fp_leaf("int64", 0, 2, cuda_device)]
    before = fingerprint.launches
    fps = integrity.device_fingerprints(tree)
    torch.cuda.synchronize()
    assert fingerprint.launches == before + 1
    host = integrity.host_fingerprints({k: ([x.cpu() for x in v] if isinstance(v, list) else v.cpu()) for k, v in tree.items()})
    assert {k: integrity._fp_host(v).tolist() for k, v in fps.items()} == {k: v.tolist() for k, v in host.items()}


@pytest.mark.parametrize("row", [1, 2, 3, 5, 7, 1001, 4099])
def test_fingerprint_per_shard_rows_at_any_alignment(cuda_device, row):
    """Shard rows of a stack start at every 4-byte offset of a 16-byte line:
    the head and tail words around the vector loads."""
    from torchmetrics_tpu_torch import integrity
    from torchmetrics_tpu_torch.ops import fingerprint

    stack = _fp_leaf("int32", 8 * row, seed=row).reshape(8, row)
    got = integrity.device_shard_fingerprints({"s": stack.to(cuda_device)})["['s']"]
    torch.cuda.synchronize()
    assert _words_equal(got, fingerprint._fingerprint_reference(*stack.unbind(0)))


def test_fingerprint_leaf_past_2_31_words(cuda_device):
    """2**31 + 3 int32 words (8.6 GB): the kernel indexes in int64."""
    from torchmetrics_tpu_torch.ops import fingerprint

    n = 2**31 + 3
    leaf = torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(3))
    got = fingerprint.fingerprint_segments([leaf])
    want = fingerprint._fingerprint_reference(leaf)
    torch.cuda.synchronize()
    assert _words_equal(got, want)
    del leaf
    torch.cuda.empty_cache()


def test_fingerprint_refuses_what_it_cannot_take(cuda_device):
    from torchmetrics_tpu_torch.ops import fingerprint

    x = torch.ones(4, 6, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fingerprint.fingerprint_segments([x.t()])
    with pytest.raises(ValueError, match="devices"):
        fingerprint.fingerprint_segments([x, torch.ones(3)])


@pytest.mark.parametrize("policy", ["raise", "restore", "degraded"])
def test_integrity_auditor_on_card(cuda_device, policy):
    """A flipped bit in a card state, caught at the next read: raised,
    restored bit for bit, or served as the last-good value."""
    from torchmetrics_tpu_torch.ops.async_read import drain_pipeline
    from torchmetrics_tpu_torch.quarantine import DegradedValue
    from torchmetrics_tpu_torch.testing import faults
    from torchmetrics_tpu_torch.utils.exceptions import StateDivergenceError

    c = 10
    m = MulticlassConfusionMatrix(num_classes=c, validate_args=False, device=cuda_device)
    m.attach_integrity(on_divergence=policy)
    g = torch.Generator().manual_seed(7)
    for _ in range(3):
        m.update(torch.randint(0, c, (64,), generator=g).to(cuda_device), torch.randint(0, c, (64,), generator=g).to(cuda_device))
    drain_pipeline(60.0)
    clean = m.compute().clone()
    faults.flip_state_bits(m, seed=11)
    if policy == "raise":
        with pytest.raises(StateDivergenceError):
            m.compute()
        with pytest.raises(StateDivergenceError):
            m.compute_async().result(60.0)
    elif policy == "restore":
        assert torch.equal(m.compute(), clean)
        assert m.integrity.stats["restores"] == 1
    else:
        got = m.compute()
        assert isinstance(got, DegradedValue) and torch.equal(got.value, clean)


def test_fingerprint_table_past_the_inline_limit(cuda_device):
    """More segments than ride in the launch's parameters: the table goes
    to the card by a copy, one launch all the same."""
    from torchmetrics_tpu_torch import integrity
    from torchmetrics_tpu_torch.ops import fingerprint

    rows = fingerprint.INLINE_SEGMENTS + 72
    stack = _fp_leaf("int64", rows * 33, seed=4).reshape(rows, 33)
    before = fingerprint.launches
    got = integrity.device_shard_fingerprints({"s": stack.to(cuda_device)})["['s']"]
    torch.cuda.synchronize()
    assert fingerprint.launches == before + 1
    assert _words_equal(got, fingerprint._fingerprint_reference(*stack.unbind(0)))
