"""The port's BERTScore and InfoLM against the JAX package, through the same
seeded user models.

The embedders and distribution models return numpy arrays to JAX and, to
the port, either numpy arrays or CPU tensors (the forms a hook may take).
Values within rtol 1e-5 (float32 norms, products and reductions in another
order). The greedy match is batched over pairs with one ``bmm`` in the port
(JAX ``vmap``s it); padded pairs, the IDF weights (from token ids or from the
tokenizer) and the baseline rescale follow JAX. The ``transformers``
default paths run a tiny seeded BERT masked LM saved to a temporary
directory, which both packages load with ``local_files_only``.
"""
from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.functional.text.infolm import _InformationMeasure

RTOL = 1e-5
DIM = 16
WORDS = "the a cat dog sat ran on over mat house quick brown fox jumps lazy river".split()


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu.functional.text as jax_f
    import torchmetrics_tpu.text as jax_text

    return jnp, jax_f, jax_text


def _close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=1e-7)


def _sentences(seed, n=9):
    rng = np.random.RandomState(seed)
    return [" ".join(WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(1, 9))) for _ in range(n)]


def _embedder(with_ids: bool, as_tensor: bool = False):
    """Word embeddings hashed from each lower-cased word (so equal words
    embed equally), zero-padded, with token ids from the same hash."""

    def embed(sentences):
        width = max(len(s.split()) for s in sentences)
        emb = np.zeros((len(sentences), width, DIM), dtype=np.float32)
        mask = np.zeros((len(sentences), width), dtype=bool)
        ids = np.zeros((len(sentences), width), dtype=np.int64)
        for i, s in enumerate(sentences):
            for j, tok in enumerate(s.lower().split()):
                h = zlib.crc32(tok.encode())
                emb[i, j] = np.random.default_rng(h).normal(size=DIM)
                mask[i, j] = True
                ids[i, j] = h % 1000
        out = (emb, mask, ids) if with_ids else (emb, mask)
        return tuple(torch.from_numpy(a) for a in out) if as_tensor else out

    return embed


def _ref_scores(jax_f, preds, target, **kwargs):
    out = jax_f.bert_score(preds, target, **kwargs)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("with_ids", [False, True])
@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_bert_score(with_ids, idf, as_tensor):
    _, jax_f, _ = _jax()
    preds, target = _sentences(1), _sentences(2)
    port = F.bert_score(preds, target, user_model=_embedder(with_ids, as_tensor), idf=idf, device="cpu")
    ref = _ref_scores(jax_f, preds, target, user_model=_embedder(with_ids), idf=idf)
    for k in ("precision", "recall", "f1"):
        _close(port[k], ref[k])
        assert port[k].dtype == torch.float32


def test_bert_score_user_tokenizer_and_baseline():
    _, jax_f, _ = _jax()
    preds, target = _sentences(3), _sentences(4)
    kwargs = {"user_tokenizer": lambda s: s.split()[::-1], "idf": True, "rescale_with_baseline": True,
              "baseline": [0.31, 0.29, 0.3]}
    port = F.bert_score(preds, target, user_model=_embedder(False), device="cpu", **kwargs)
    ref = _ref_scores(jax_f, preds, target, user_model=_embedder(False), **kwargs)
    for k in ("precision", "recall", "f1"):
        _close(port[k], ref[k])
    with pytest.raises(ValueError, match="baseline"):
        F.bert_score(preds, target, user_model=_embedder(False), rescale_with_baseline=True, device="cpu")


def test_bert_score_edges():
    _, jax_f, _ = _jax()
    out = F.bert_score([], [], user_model=_embedder(False), device="cpu")
    assert all(v.shape == (0,) for v in out.values())
    # identical sentences score 1; a padded (shorter) partner still matches
    out = F.bert_score(["the cat sat", "a dog"], ["the cat sat", "a dog ran on the mat"], user_model=_embedder(True), device="cpu")
    ref = _ref_scores(jax_f, ["the cat sat", "a dog"], ["the cat sat", "a dog ran on the mat"], user_model=_embedder(True))
    for k in ("precision", "recall", "f1"):
        _close(out[k], ref[k])
    assert float(out["f1"][0]) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="must match"):
        F.bert_score(["a"], ["a", "b"], user_model=_embedder(False), device="cpu")


def test_bert_score_refuses_a_tensor_on_another_device():
    def meta_model(sentences):
        return torch.zeros(len(sentences), 2, DIM, device="meta"), torch.ones(len(sentences), 2, dtype=torch.bool)

    with pytest.raises(RuntimeError, match="never copied"):
        F.bert_score(["a b"], ["a b"], user_model=meta_model, device="cpu")


def test_bert_score_class_accumulates_and_resets():
    _, _, jax_text = _jax()
    preds, target = _sentences(5, 12), _sentences(6, 12)
    port = tm.BERTScore(user_model=_embedder(True, True), idf=True, device="cpu")
    ref = jax_text.BERTScore(user_model=_embedder(True), idf=True)
    for start in range(0, 12, 5):
        port.update(preds[start : start + 5], target[start : start + 5])
        ref.update(preds[start : start + 5], target[start : start + 5])
    port_v, ref_v = port.compute(), ref.compute()
    for k in ("precision", "recall", "f1"):
        _close(port_v[k], ref_v[k])
    port.reset()
    assert port._preds == [] and port._target == []
    port.update(preds[:2], target[:2])
    assert port.compute()["f1"].shape == (2,)


MEASURES = [
    ("kl_divergence", {}),
    ("alpha_divergence", {"alpha": 0.5}),
    ("alpha_divergence", {"alpha": 2.0}),
    ("beta_divergence", {"beta": 0.5}),
    ("ab_divergence", {"alpha": 0.5, "beta": 0.5}),
    ("ab_divergence", {"alpha": 1.5, "beta": -0.5}),
    ("renyi_divergence", {"alpha": 0.5}),
    ("l1_distance", {}),
    ("l2_distance", {}),
    ("l_infinity_distance", {}),
    ("fisher_rao_distance", {}),
]


def _distribution(as_tensor: bool = False, vocab: int = 40):
    """A seeded distribution over ``vocab`` tokens for each sentence."""

    def dist(sentences):
        out = np.zeros((len(sentences), vocab), dtype=np.float32)
        for i, s in enumerate(sentences):
            row = np.random.default_rng(zlib.crc32(s.encode())).random(vocab).astype(np.float32) + 1e-3
            out[i] = row / row.sum()
        return torch.from_numpy(out) if as_tensor else out

    return dist


@pytest.mark.parametrize("measure,kwargs", MEASURES, ids=[f"{m}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for m, kw in MEASURES])
@pytest.mark.parametrize("temperature", [0.25, 1.0])
def test_infolm(measure, kwargs, temperature):
    _, jax_f, _ = _jax()
    preds, target = _sentences(7), _sentences(8)
    port = F.infolm(preds, target, temperature=temperature, information_measure=measure, user_model=_distribution(True),
                    return_sentence_level_score=True, device="cpu", **kwargs)
    ref = jax_f.infolm(preds, target, temperature=temperature, information_measure=measure, user_model=_distribution(),
                       return_sentence_level_score=True, **kwargs)
    _close(port[0], ref[0])
    _close(port[1], ref[1])


def test_beta_divergence_sets_alpha_on_the_measure():
    """Kept reference behaviour: the beta divergence sets ``alpha`` to 1.0 on
    the measure object, so a later call of the same object sees it."""
    from torchmetrics_tpu.functional.text.infolm import _InformationMeasure as JaxMeasure

    port, ref = _InformationMeasure("beta_divergence", beta=0.5), JaxMeasure("beta_divergence", beta=0.5)
    assert port.alpha == ref.alpha == 0.0
    p, t = _distribution()(["a", "b"]), _distribution()(["c", "d"])
    jnp, _, _ = _jax()
    _close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)))
    assert port.alpha == ref.alpha == 1.0


def test_infolm_nan_to_num_and_checks():
    _, jax_f, _ = _jax()

    def with_zeros(sentences):
        out = _distribution()(sentences)
        out[:, :5] = 0.0
        return out / out.sum(1, keepdims=True)

    preds, target = _sentences(9, 4), _sentences(10, 4)
    for measure in ("kl_divergence", "renyi_divergence"):
        kwargs = {"alpha": 1.5} if measure == "renyi_divergence" else {}
        port = F.infolm(preds, target, information_measure=measure, user_model=with_zeros, device="cpu", **kwargs)
        ref = jax_f.infolm(preds, target, information_measure=measure, user_model=with_zeros, **kwargs)
        _close(port, ref)
    with pytest.raises(ValueError, match="alpha"):
        tm.InfoLM(information_measure="alpha_divergence", alpha=1.0, device="cpu")
    with pytest.raises(ValueError, match="information_measure"):
        F.infolm(["a"], ["a"], information_measure="cosine", user_model=_distribution(), device="cpu")


def test_infolm_class_accumulates_and_resets():
    _, _, jax_text = _jax()
    preds, target = _sentences(11, 10), _sentences(12, 10)
    port = tm.InfoLM(information_measure="l2_distance", user_model=_distribution(True), return_sentence_level_score=True, device="cpu")
    ref = jax_text.InfoLM(information_measure="l2_distance", user_model=_distribution(), return_sentence_level_score=True)
    for start in range(0, 10, 4):
        port.update(preds[start : start + 4], target[start : start + 4])
        ref.update(preds[start : start + 4], target[start : start + 4])
    port_v, ref_v = port.compute(), ref.compute()
    _close(port_v[0], ref_v[0])
    _close(port_v[1], ref_v[1])
    port.reset()
    assert port._preds == [] and port._target == []


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    """A tiny seeded BERT masked LM and its word-level tokenizer, saved
    locally (the default embedders load local files only)."""
    transformers = pytest.importorskip("transformers")
    path = tmp_path_factory.mktemp("tiny_bert")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *WORDS]
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizer(str(path / "vocab.txt")).save_pretrained(path)
    config = transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32,
    )
    torch.manual_seed(0)
    transformers.BertForMaskedLM(config).eval().save_pretrained(path)
    return str(path)


@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_default_embedder(tiny_bert, idf):
    """The ``transformers`` default embedder (local files only, run on the
    metric's device, special tokens masked) against the JAX package's."""
    _, jax_f, _ = _jax()
    preds, target = _sentences(13, 5), _sentences(14, 5)
    port = F.bert_score(preds, target, model_name_or_path=tiny_bert, idf=idf, device="cpu")
    ref = _ref_scores(jax_f, preds, target, model_name_or_path=tiny_bert, idf=idf)
    for k in ("precision", "recall", "f1"):
        _close(port[k], ref[k])


@pytest.mark.parametrize("idf", [False, True])
def test_infolm_default_masked_lm(tiny_bert, idf):
    """The ``transformers`` masked-LM distribution (every non-special
    position masked in turn; the port masks them all in one batch) against
    the JAX package's."""
    _, jax_f, _ = _jax()
    preds, target = _sentences(15, 4), _sentences(16, 4)
    port = F.infolm(preds, target, model_name_or_path=tiny_bert, idf=idf, information_measure="l1_distance", device="cpu",
                    return_sentence_level_score=True)
    ref = jax_f.infolm(preds, target, model_name_or_path=tiny_bert, idf=idf, information_measure="l1_distance",
                       return_sentence_level_score=True)
    _close(port[0], ref[0])
    _close(port[1], ref[1])
