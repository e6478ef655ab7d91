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
