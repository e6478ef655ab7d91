"""The PyTorch port stands alone: no file of ``torchmetrics_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and importing the port
leaves both out of ``sys.modules``. ``chip_smoke.py`` refuses to run (and
prints no result) without a CUDA device or without the port beside it.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "torchmetrics_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "torchmetrics_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == root or module.startswith(root + ".") for root in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "import_module",
            "__import__",
        ):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                yield node.args[0].value


def test_sources_were_found():
    names = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {
        "chip_smoke.py",
        "torchmetrics_tpu_torch/metric.py",
        "torchmetrics_tpu_torch/ops/bincount.py",
        "torchmetrics_tpu_torch/ops/binned_curve.py",
        "torchmetrics_tpu_torch/ops/topk_kernel.py",
        "torchmetrics_tpu_torch/ops/ssim_kernel.py",
        "torchmetrics_tpu_torch/ops/sqrtm_kernel.py",
        "torchmetrics_tpu_torch/models/inception.py",
        "torchmetrics_tpu_torch/utils/prng.py",
        "torchmetrics_tpu_torch/native/__init__.py",
        "torchmetrics_tpu_torch/functional/text/helper.py",
        "torchmetrics_tpu_torch/text/model_based.py",
        "torchmetrics_tpu_torch/functional/audio/pesq.py",
        "torchmetrics_tpu_torch/functional/audio/stoi.py",
        "torchmetrics_tpu_torch/functional/audio/srmr.py",
        "torchmetrics_tpu_torch/audio/dsp.py",
        "torchmetrics_tpu_torch/functional/clustering/utils.py",
        "torchmetrics_tpu_torch/clustering/metrics.py",
        "torchmetrics_tpu_torch/detection/mean_ap.py",
        "torchmetrics_tpu_torch/detection/helpers.py",
        "torchmetrics_tpu_torch/functional/detection/panoptic_quality.py",
        "torchmetrics_tpu_torch/functional/segmentation/utils.py",
        "torchmetrics_tpu_torch/multimodal/clip_score.py",
        "torchmetrics_tpu_torch/obs/__init__.py",
        "torchmetrics_tpu_torch/obs/tracer.py",
        "torchmetrics_tpu_torch/obs/flight.py",
        "torchmetrics_tpu_torch/obs/registry.py",
        "torchmetrics_tpu_torch/obs/export.py",
        "torchmetrics_tpu_torch/io/checkpoint.py",
        "torchmetrics_tpu_torch/ops/async_read.py",
        "torchmetrics_tpu_torch/integrity.py",
        "torchmetrics_tpu_torch/testing/__init__.py",
        "torchmetrics_tpu_torch/testing/faults.py",
        "torchmetrics_tpu_torch/lanes.py",
        "torchmetrics_tpu_torch/quarantine.py",
        "torchmetrics_tpu_torch/ops/ingest.py",
        "torchmetrics_tpu_torch/ops/fused_classification.py",
    } <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = sorted(m for m in _imports(path) if _forbidden(m))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _run(args, cwd, env=None):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=300, env=env
    )


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, torchmetrics_tpu_torch, torchmetrics_tpu_torch.functional, torchmetrics_tpu_torch.utils.convert\n"
        "import torchmetrics_tpu_torch.retrieval, torchmetrics_tpu_torch.image, torchmetrics_tpu_torch.text\n"
        "import torchmetrics_tpu_torch.native, torchmetrics_tpu_torch.audio, torchmetrics_tpu_torch.clustering\n"
        "import torchmetrics_tpu_torch.detection, torchmetrics_tpu_torch.multimodal\n"
        "import torchmetrics_tpu_torch.functional.segmentation, torchmetrics_tpu_torch.functional.multimodal\n"
        "import torchmetrics_tpu_torch.lanes, torchmetrics_tpu_torch.quarantine, torchmetrics_tpu_torch.ops.ingest\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'torchmetrics_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = _run(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(["chip_smoke.py"], cwd=REPO, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(["chip_smoke.py"], cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
