"""The port's PESQ library (``torchmetrics_tpu_torch/native/pesq.cpp``)
against the JAX package's.

The port builds its own copy of ``pesq.cpp`` (byte-equal to the JAX
package's) into ``torchmetrics_tpu_torch/_build/libtm_pesq-<hash>.so``, a
library of its own beside the text library, never into the JAX loader's
per-user cache. Its MOS-LQO must equal JAX's bit for bit (both are the same
float64 C++ code, rounded to float32 by the metric). A signal the library
refuses scores NaN with a warning, and without a compiler PESQ raises:
there is no pure-Python PESQ.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "audio" / "fixtures"
SPEECH = np.load(REPO / "tests" / "fixtures_real" / "speech.npz")


def _jax():
    import torchmetrics_tpu.functional as jax_functional
    import torchmetrics_tpu.native as jax_native

    return jax_native, jax_functional


def _pairs(fs: int, seed: int, count: int = 4, seconds: float = 2.0):
    """Seeded clean/degraded speech-shaped pairs: the fixture clips at ``fs``,
    shifted, with noise at 30 to 0 dB SNR and a short echo."""
    rng = np.random.RandomState(seed)
    step = 16000 // fs
    n = int(seconds * fs)
    clean, deg = [], []
    for k in range(count):
        clip = (SPEECH["clip1"] if k % 2 == 0 else SPEECH["clip2"]).astype(np.float64)[::step]
        tiled = np.tile(clip, n // len(clip) + 2)
        shift = rng.randint(0, len(clip))
        c = tiled[shift : shift + n]
        snr_db = rng.uniform(0, 30)
        noise = rng.randn(n) * np.sqrt((c**2).mean() / 10 ** (snr_db / 10))
        clean.append(c)
        deg.append(c + 0.2 * np.roll(c, rng.randint(1, 40)) + noise)
    return np.stack(deg), np.stack(clean)


def test_the_pesq_library_is_the_ports_own_build():
    path = native.pesq_library_path()
    assert path.parent == REPO / "torchmetrics_tpu_torch" / "_build"
    assert path.name.startswith("libtm_pesq-") and path.suffix == ".so"
    assert path != native.library_path()
    assert native.pesq_available()
    assert path.exists() and native.pesq_build_error() is None
    assert native.build_pesq() == path


def test_the_source_is_a_byte_copy_of_the_jax_packages():
    ours = REPO / "torchmetrics_tpu_torch" / "native" / "pesq.cpp"
    assert ours.read_bytes() == (REPO / "torchmetrics_tpu" / "native" / "pesq.cpp").read_bytes()
    assert native.PESQ_SOURCE == ours


def test_building_never_touches_the_jax_cache(tmp_path):
    env = dict(os.environ, HOME=str(tmp_path), XDG_CACHE_HOME=str(tmp_path / "cache"))
    code = (
        "import sys, numpy as np\n"
        "from torchmetrics_tpu_torch import native\n"
        "assert native.pesq_available()\n"
        "t = np.sin(np.arange(8000) * 0.3)[None]\n"
        "print(round(float(native.pesq_batch(t, t, 8000, False)[0]), 2))\n"
        "assert not any(m.split('.')[0] == 'torchmetrics_tpu' for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.strip()) > 4.0
    assert not (tmp_path / "cache" / "tm_tpu_native").exists()
    assert not (tmp_path / ".cache" / "tm_tpu_native").exists()


@pytest.mark.parametrize("fs,mode", [(8000, "nb"), (16000, "wb")])
def test_itu_anchor_fixtures_bit_for_bit(fs, mode):
    _, jf = _jax()
    ref = np.load(FIXTURES / "pesq_anchor_ref.npy")
    deg = np.load(FIXTURES / "pesq_anchor_deg.npy")
    want = np.asarray(jf.perceptual_evaluation_speech_quality(deg, ref, fs, mode))
    got = F.perceptual_evaluation_speech_quality(torch.tensor(deg), torch.tensor(ref), fs, mode)
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
    np.testing.assert_allclose(float(got), {"nb": 2.2076, "wb": 1.7359}[mode], atol=0.05)


@pytest.mark.parametrize("fs,mode", [(8000, "nb"), (16000, "nb"), (16000, "wb")])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_pairs_bit_for_bit(fs, mode, seed):
    jax_native, jf = _jax()
    deg, clean = _pairs(fs, seed)
    want = np.asarray(jf.perceptual_evaluation_speech_quality(deg, clean, fs, mode))
    got = F.perceptual_evaluation_speech_quality(torch.tensor(deg), torch.tensor(clean), fs, mode)
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
    raw = native.pesq_batch(clean, deg, fs, mode == "wb")
    assert raw.tobytes() == jax_native.pesq_batch(clean, deg, fs, mode == "wb").tobytes()
    # batch shape and float32 inputs: one read to float64, scores of the batch shape
    got2 = F.perceptual_evaluation_speech_quality(torch.tensor(deg.reshape(2, 2, -1)), torch.tensor(clean.reshape(2, 2, -1)), fs, mode)
    assert got2.shape == (2, 2) and np.array_equal(got2.numpy().reshape(-1), got.numpy())


def test_an_error_signal_is_nan_with_the_warning():
    _, jf = _jax()
    deg, clean = _pairs(8000, 5, count=2)
    deg[1, 400:], clean[1, 400:] = 0.0, 0.0
    short = np.stack([deg[0], deg[1]])[:, :200]
    with pytest.warns(RuntimeWarning, match="returning NaN"):
        got = F.perceptual_evaluation_speech_quality(torch.tensor(short), torch.tensor(clean[:, :200]), 8000, "nb")
    with pytest.warns(RuntimeWarning, match="returning NaN"):
        want = np.asarray(jf.perceptual_evaluation_speech_quality(short, clean[:, :200], 8000, "nb"))
    assert np.isnan(got.numpy()).all() and np.isnan(want).all()
    # the class leaves a NaN signal out of its sum and its count
    metric = tm.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu")
    good = F.perceptual_evaluation_speech_quality(torch.tensor(deg[:1]), torch.tensor(clean[:1]), 8000, "nb")
    metric.update(torch.tensor(deg[:1]), torch.tensor(clean[:1]))
    with pytest.warns(RuntimeWarning, match="returning NaN"):
        metric.update(torch.tensor(short[:1]), torch.tensor(clean[:1, :200]))
    assert int(metric.total) == 1 and float(metric.compute()) == float(good[0])


def test_argument_errors_as_in_jax():
    x = torch.zeros(8000)
    with pytest.raises(ValueError, match="fs"):
        F.perceptual_evaluation_speech_quality(x, x, 44100, "nb")
    with pytest.raises(ValueError, match="mode"):
        F.perceptual_evaluation_speech_quality(x, x, 8000, "xb")
    with pytest.raises(ValueError, match="requires `fs=16000`"):
        F.perceptual_evaluation_speech_quality(x, x, 8000, "wb")
    with pytest.raises(RuntimeError, match="same shape"):
        F.perceptual_evaluation_speech_quality(x, torch.zeros(800), 8000, "nb")
    with pytest.raises(ValueError, match="requires `fs=16000`"):
        tm.PerceptualEvaluationSpeechQuality(8000, "wb", device="cpu")


def test_without_a_compiler_pesq_raises_and_the_text_library_is_untouched(monkeypatch, tmp_path):
    text_lib, text_tried = native._LIB, native._TRIED
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_PESQ_LIB", None)
    monkeypatch.setattr(native, "_PESQ_TRIED", False)
    monkeypatch.setattr(native, "_PESQ_ERROR", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no-compiler-here"))
    assert not native.pesq_available()
    assert native.pesq_batch(np.zeros((1, 8000)), np.zeros((1, 8000)), 8000, False) is None
    with pytest.raises(ModuleNotFoundError, match="no pure-Python PESQ") as err:
        F.perceptual_evaluation_speech_quality(torch.zeros(8000), torch.zeros(8000), 8000, "nb")
    assert "g++" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))
    assert (native._LIB, native._TRIED) == (text_lib, text_tried)


def test_a_broken_source_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "pesq.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "PESQ_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_PESQ_LIB", None)
    monkeypatch.setattr(native, "_PESQ_TRIED", False)
    monkeypatch.setattr(native, "_PESQ_ERROR", None)
    with pytest.raises(ModuleNotFoundError, match="error"):
        F.perceptual_evaluation_speech_quality(torch.zeros(8000), torch.zeros(8000), 8000, "nb")
    assert not list((tmp_path / "_build").glob("*.so"))
