"""The port's CLIPScore and CLIP-IQA against the JAX package.

Both packages take the same embedding hooks (numpy in, numpy out, so each
package sees identical features); scores and probabilities within 1e-5
(float32 norms and products), images as a list and as a tensor, the
keyword prompts and custom prompt pairs.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F

TOL = 1e-5
F_DIM = 16


def _jax():
    import torchmetrics_tpu as jax_tm
    import torchmetrics_tpu.functional as jax_functional

    return jax_tm, jax_functional


_W = np.random.RandomState(0).randn(3 * 4, F_DIM).astype(np.float32)


def _image_features(images) -> np.ndarray:
    """Mean colour of each image's four quadrants, projected: numpy out."""
    x = np.asarray(images, dtype=np.float32)
    h, w = x.shape[-2] // 2, x.shape[-1] // 2
    quads = [x[..., :h, :w], x[..., :h, w:], x[..., h:, :w], x[..., h:, w:]]
    return np.concatenate([q.mean(axis=(-2, -1)) for q in quads], axis=-1) @ _W


def _text_features(texts) -> np.ndarray:
    rows = []
    for t in texts:
        rng = np.random.RandomState(sum(ord(c) for c in t) % (2**31))
        rows.append(rng.randn(F_DIM))
    return np.asarray(rows, np.float32)


def embed(images, texts):
    return _image_features(images), _text_features(texts)


def _images(seed: int, n: int = 5) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, 3, 8, 10).astype(np.float32)


CAPTIONS = ["a cat on a mat", "two dogs", "a red car", "the sea at dusk", "a plate of food"]


@pytest.mark.parametrize("form", ["tensor", "list", "single"])
def test_clip_score_against_jax(form):
    import jax.numpy as jnp

    _, jf = _jax()
    imgs = _images(1)
    if form == "list":
        port_in, jax_in, text = [torch.from_numpy(i) for i in imgs], [jnp.asarray(i) for i in imgs], CAPTIONS
    elif form == "single":
        port_in, jax_in, text = torch.from_numpy(imgs[0]), jnp.asarray(imgs[0]), CAPTIONS[0]
    else:
        port_in, jax_in, text = torch.from_numpy(imgs), jnp.asarray(imgs), CAPTIONS
    got = F.clip_score(port_in, text, embedding_fn=embed)
    np.testing.assert_allclose(float(got), float(jf.clip_score(jax_in, text, embedding_fn=embed)), rtol=TOL, atol=TOL)


def test_clip_score_class_against_jax():
    jax_tm, _ = _jax()
    port, ref = tm.CLIPScore(embedding_fn=embed, device="cpu"), jax_tm.CLIPScore(embedding_fn=embed)
    for seed in (2, 3):
        imgs = _images(seed)
        port.update(torch.from_numpy(imgs), CAPTIONS)
        ref.update(imgs, CAPTIONS)
    assert port.score.dtype == torch.float32 and port.n_samples.dtype == torch.int32
    assert int(port.n_samples) == int(ref.n_samples) == 10
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=TOL, atol=TOL)


def test_clip_score_refuses_bad_inputs():
    with pytest.raises(ModuleNotFoundError, match="embedding_fn"):
        tm.CLIPScore(device="cpu")
    with pytest.raises(ValueError, match="same"):
        F.clip_score(torch.from_numpy(_images(1)), CAPTIONS[:2], embedding_fn=embed)
    with pytest.raises(ValueError, match="3d"):
        F.clip_score(torch.zeros(2, 1, 3, 8, 8), CAPTIONS[:2], embedding_fn=embed)


@pytest.mark.parametrize(
    "prompts",
    [("quality",), ("quality", "brightness", "sharpness"), (("Good photo.", "Bad photo."), "contrast"), (("A", "B"), ("C", "D"))],
)
@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_clip_iqa_against_jax(prompts, data_range):
    jax_tm, jf = _jax()
    imgs = _images(4) * data_range
    got = F.clip_image_quality_assessment(torch.from_numpy(imgs), _image_features, _text_features, prompts, data_range)
    want = jf.clip_image_quality_assessment(imgs, _image_features, _text_features, prompts, data_range)
    port = tm.CLIPImageQualityAssessment(_image_features, _text_features, prompts, data_range, device="cpu")
    ref = jax_tm.CLIPImageQualityAssessment(_image_features, _text_features, prompts, data_range)
    for part in (imgs[:2], imgs[2:]):
        port.update(torch.from_numpy(part))
        ref.update(part)
    for g, w in ((got, want), (port.compute(), ref.compute())):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=TOL, atol=TOL)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_clip_iqa_refuses_bad_prompts():
    for bad in (["quality"], ("nope",), (("only one",),), (3,)):
        with pytest.raises(ValueError):
            tm.CLIPImageQualityAssessment(_image_features, _text_features, bad, device="cpu")
    with pytest.raises(ModuleNotFoundError):
        tm.CLIPImageQualityAssessment(device="cpu")
