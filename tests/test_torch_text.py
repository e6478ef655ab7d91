"""The port's text functionals and classes against the JAX package.

The same seeded strings (and numpy logits for perplexity) go through JAX and
through the port on the CPU. Tolerances:

- counts bit for bit: edit distances, BLEU's numerator and denominator,
  chrF's n-gram totals, TER's edits and reference lengths, perplexity's
  count, SQuAD's sums and count, the ASR states;
- values formed from exact counts with the same host or float32 arithmetic
  in both packages (the ASR rates, edit distance, TER, SQuAD, the sentence
  scores of EED and TER) bit for bit;
- other values within rtol 1e-6 (float32 ``exp``/``log`` and reduction
  order: BLEU, chrF, EED's mean, ROUGE), perplexity within rtol 1e-5.

The CJK paths (``zh`` and ``char`` tokenizers, TER's ``asian_support``,
ROUGE on CJK, EED's ``ja``) read ``tests/fixtures_real/text_corpus.json``.
"""
from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.functional as F
from torchmetrics_tpu_torch.ops import kernels

CORPUS = json.loads((Path(__file__).resolve().parent / "fixtures_real" / "text_corpus.json").read_text())
RTOL = 1e-6
PPL_RTOL = 1e-5

WORDS = (
    "the a an cat dog sat ran on over mat house quick brown fox jumps lazy river bank money interest rate"
    " committee approved proposal Tuesday evening scientists discovered species fish trench central kept"
    " Der Hund lief über die Straße und das Haus"
).split()
MARKS = [",", ".", "!", "?", ";", ":", "'s", "-", "(", ")", '"', "&", "$", "%", "3.5", "1,000", "e.g.", "U.S.", "Dr."]


def _jax():
    import jax.numpy as jnp

    import torchmetrics_tpu.functional.text as jax_f
    import torchmetrics_tpu.text as jax_text

    return jnp, jax_f, jax_text


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(port, ref):
    """Bit for bit, in the same dtype (NaN equal to NaN)."""
    port, ref = _np(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    assert np.array_equal(port, ref, equal_nan=True), (port, ref)


def _close(port, ref, rtol=RTOL):
    port, ref = _np(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=0, equal_nan=True)


def _sentence(rng, lo=3, hi=16, marks=0.15, caps=0.1):
    words = []
    for _ in range(rng.randint(lo, hi)):
        w = MARKS[rng.randint(len(MARKS))] if rng.rand() < marks else WORDS[rng.randint(len(WORDS))]
        words.append(w.capitalize() if rng.rand() < caps else w)
    return " ".join(words)


def _noisy(rng, sentence, rate=0.2):
    """The sentence with planted word substitutions, insertions, deletions
    and one moved phrase."""
    words = sentence.split()
    out = []
    for w in words:
        r = rng.rand()
        if r < rate / 3:
            out.append(WORDS[rng.randint(len(WORDS))])
        elif r < 2 * rate / 3:
            out.extend([w, WORDS[rng.randint(len(WORDS))]])
        elif r < rate:
            continue
        else:
            out.append(w)
    if len(out) > 5 and rng.rand() < 0.5:
        i, j = sorted(rng.choice(len(out), 2, replace=False))
        out = out[:i] + out[j:] + out[i:j]
    return " ".join(out)


def _corpus(seed, n=12, refs=1):
    """``n`` predictions and, for each, ``refs`` noisy references."""
    rng = np.random.RandomState(seed)
    targets = [[_sentence(rng)] for _ in range(n)]
    for t in targets:
        t.extend(_noisy(rng, t[0], 0.3) for _ in range(refs - 1))
    preds = [_noisy(rng, t[0]) for t in targets]
    return preds, targets


def _batches(preds, target, sizes=(5, 4, 3)):
    out, start = [], 0
    for size in sizes:
        out.append((preds[start : start + size], target[start : start + size]))
        start += size
    return out


# ------------------------------------------------------------------------ ASR
ASR = [
    ("word_error_rate", "WordErrorRate", ("errors", "total")),
    ("char_error_rate", "CharErrorRate", ("errors", "total")),
    ("match_error_rate", "MatchErrorRate", ("errors", "total")),
    ("word_information_lost", "WordInfoLost", ("errors", "target_total", "preds_total")),
    ("word_information_preserved", "WordInfoPreserved", ("errors", "target_total", "preds_total")),
]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fn,cls,states", ASR, ids=[a[0] for a in ASR])
def test_asr_functional_and_class(fn, cls, states, seed):
    _, jax_f, jax_text = _jax()
    preds, targets = _corpus(seed, n=12)
    target = [t[0] for t in targets]
    _same(getattr(F, fn)(preds, target, device="cpu"), getattr(jax_f, fn)(preds, target))
    port, ref = getattr(tm, cls)(device="cpu"), getattr(jax_text, cls)()
    for p, t in _batches(preds, target):
        port.update(p, t)
        ref.update(p, t)
    for name in states:
        _same(getattr(port, name), getattr(ref, name))
    _same(port.compute(), ref.compute())


@pytest.mark.parametrize("fn,cls,states", ASR, ids=[a[0] for a in ASR])
def test_asr_empty_and_zero_references(fn, cls, states):
    """0/0 is NaN and x/0 inf in both packages, on host floats (the
    functional) and on the states (the class)."""
    _, jax_f, jax_text = _jax()
    for preds, target in ([[""], [""]], [["a b"], [""]], [["hello world"], ["hello world"]], [[], []]):
        _same(getattr(F, fn)(preds, target, device="cpu"), getattr(jax_f, fn)(preds, target))
        port, ref = getattr(tm, cls)(device="cpu"), getattr(jax_text, cls)()
        port.update(preds, target)
        ref.update(preds, target)
        _same(port.compute(), ref.compute())


def test_asr_single_strings_and_length_mismatch():
    _, jax_f, _ = _jax()
    _same(F.word_error_rate("a b c", "a c", device="cpu"), jax_f.word_error_rate("a b c", "a c"))
    with pytest.raises(ValueError, match="same length"):
        F.word_error_rate(["a"], ["a", "b"], device="cpu")


# --------------------------------------------------------------- EditDistance
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("substitution_cost", [0, 1, 2])
def test_edit_distance(reduction, substitution_cost):
    _, jax_f, jax_text = _jax()
    preds, targets = _corpus(11 + substitution_cost, n=12)
    target = [t[0] for t in targets]
    _same(
        F.edit_distance(preds, target, substitution_cost, reduction, device="cpu"),
        jax_f.edit_distance(preds, target, substitution_cost, reduction),
    )
    port = tm.EditDistance(substitution_cost=substitution_cost, reduction=reduction, device="cpu")
    ref = jax_text.EditDistance(substitution_cost=substitution_cost, reduction=reduction)
    for p, t in _batches(preds, target):
        port.update(p, t)
        ref.update(p, t)
    _same(port.compute(), ref.compute())


def test_edit_distance_edges():
    _, jax_f, jax_text = _jax()
    _same(F.edit_distance([], [], device="cpu"), jax_f.edit_distance([], []))
    _same(F.edit_distance("kitten", "sitting", device="cpu"), jax_f.edit_distance("kitten", "sitting"))
    for reduction in ("mean", "none"):
        port = tm.EditDistance(reduction=reduction, device="cpu")
        ref = jax_text.EditDistance(reduction=reduction)
        port.update([], [])
        ref.update([], [])
        _same(port.compute(), ref.compute())
    with pytest.raises(ValueError, match="string type"):
        F.edit_distance([1], ["a"], device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        tm.EditDistance(reduction="max", device="cpu")


# ------------------------------------------------------------------------ EED
@pytest.mark.parametrize("refs", [1, 2, 3])
@pytest.mark.parametrize("sentence_level", [False, True])
def test_extended_edit_distance(refs, sentence_level):
    _, jax_f, jax_text = _jax()
    preds, target = _corpus(20 + refs, n=10, refs=refs)
    kwargs = {"return_sentence_level_score": sentence_level, "alpha": 1.5, "rho": 0.4, "deletion": 0.3, "insertion": 0.9}
    port_v = F.extended_edit_distance(preds, target, device="cpu", **kwargs)
    ref_v = jax_f.extended_edit_distance(preds, target, **kwargs)
    if sentence_level:
        _close(port_v[0], ref_v[0])
        _same(port_v[1], ref_v[1])
    else:
        _close(port_v, ref_v)
    port = tm.ExtendedEditDistance(device="cpu", return_sentence_level_score=sentence_level)
    ref = jax_text.ExtendedEditDistance(return_sentence_level_score=sentence_level)
    for p, t in _batches(preds, target, (4, 3, 3)):
        port.update(p, t)
        ref.update(p, t)
    port_v, ref_v = port.compute(), ref.compute()
    if sentence_level:
        _close(port_v[0], ref_v[0])
        _same(port_v[1], ref_v[1])
    else:
        _close(port_v, ref_v)


def test_extended_edit_distance_japanese_and_english_abbreviations():
    _, jax_f, _ = _jax()
    ja = CORPUS["japanese"]
    _close(
        F.extended_edit_distance(ja["preds"], [[t] for t in ja["targets"]], language="ja", device="cpu"),
        jax_f.extended_edit_distance(ja["preds"], [[t] for t in ja["targets"]], language="ja"),
    )
    preds = ["Dr. Smith met Mr. Jones, e.g. at 3 . 5 p.m.!  The U . S . team?"]
    target = [["Dr Smith met Mr Jones e . g . at 3.5 pm. The U.S. team"]]
    _close(F.extended_edit_distance(preds, target, device="cpu"), jax_f.extended_edit_distance(preds, target))
    _same(F.extended_edit_distance([], [], device="cpu"), jax_f.extended_edit_distance([], []))
    with pytest.raises(ValueError, match="language"):
        F.extended_edit_distance(["a"], [["a"]], language="de", device="cpu")


# ----------------------------------------------------------------------- BLEU
@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
def test_bleu(n_gram, smooth):
    _, jax_f, jax_text = _jax()
    preds, target = _corpus(30 + n_gram, n=12, refs=2)
    _close(F.bleu_score(preds, target, n_gram, smooth, device="cpu"), jax_f.bleu_score(preds, target, n_gram, smooth))
    port, ref = tm.BLEUScore(n_gram, smooth, device="cpu"), jax_text.BLEUScore(n_gram, smooth)
    for p, t in _batches(preds, target):
        port.update(p, t)
        ref.update(p, t)
    for name in ("numerator", "denominator", "preds_len", "target_len"):
        _same(getattr(port, name), getattr(ref, name))
    _close(port.compute(), ref.compute())


def test_bleu_weights_and_edges():
    _, jax_f, _ = _jax()
    preds, target = _corpus(37, n=8, refs=2)
    weights = [0.1, 0.2, 0.3, 0.4]
    _close(F.bleu_score(preds, target, weights=weights, device="cpu"), jax_f.bleu_score(preds, target, weights=weights))
    # no 4-gram match: 0; a short hypothesis: the brevity penalty
    _close(F.bleu_score(["a b c"], [["a b d e f"]], device="cpu"), jax_f.bleu_score(["a b c"], [["a b d e f"]]))
    _close(F.bleu_score("a b c d e", ["a b c d e f g"], device="cpu"), jax_f.bleu_score("a b c d e", ["a b c d e f g"]))
    _close(F.bleu_score([""], [["a b"]], device="cpu"), jax_f.bleu_score([""], [["a b"]]))
    with pytest.raises(ValueError, match="weights"):
        F.bleu_score(preds, target, weights=[1.0], device="cpu")
    with pytest.raises(ValueError, match="different size"):
        F.bleu_score(["a"], [], device="cpu")


SACRE_CASES = [
    ("none", False, "english"), ("13a", False, "english"), ("13a", True, "english"), ("intl", False, "english"),
    ("intl", True, "marks"), ("char", False, "english"), ("zh", False, "chinese"), ("char", False, "chinese"),
    ("13a", False, "marks"), ("zh", False, "japanese"),
]


def _sacre_inputs(kind):
    if kind == "marks":
        preds = ['He said: "It\'s 3.5% of $1,000 (e.g. 35$)!" — OK? <skipped> &amp; 4-5 items… ©2024 α+β=γ.',
                 "The U.S.-based firm's CEO, Dr. Smith, said 10,000-20,000 units."]
        target = [['He said: "It is 3.5 % of $ 1,000 (e.g. 35 $)!" - ok? & 4 - 5 items... (c)2024 α + β = γ.'],
                  ["The U.S. based firm's CEO, Dr Smith, said 10,000 - 20,000 units."]]
        return preds, target
    data = CORPUS[kind]
    return data["preds"], [[t] for t in data["targets"]]


@pytest.mark.parametrize("tokenize,lowercase,kind", SACRE_CASES)
def test_sacre_bleu(tokenize, lowercase, kind):
    _, jax_f, jax_text = _jax()
    preds, target = _sacre_inputs(kind)
    _close(
        F.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, smooth=True, device="cpu"),
        jax_f.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, smooth=True),
    )
    port = tm.SacreBLEUScore(tokenize=tokenize, lowercase=lowercase, n_gram=2, device="cpu")
    ref = jax_text.SacreBLEUScore(tokenize=tokenize, lowercase=lowercase, n_gram=2)
    for i in range(len(preds)):
        port.update(preds[i : i + 1], target[i : i + 1])
        ref.update(preds[i : i + 1], target[i : i + 1])
    for name in ("numerator", "denominator", "preds_len", "target_len"):
        _same(getattr(port, name), getattr(ref, name))
    _close(port.compute(), ref.compute())


def test_sacre_bleu_tokenizers_token_for_token():
    from torchmetrics_tpu.functional.text.bleu import _SacreBLEUTokenizer as JaxTokenizer

    from torchmetrics_tpu_torch.functional.text.bleu import _SacreBLEUTokenizer

    lines = [*_sacre_inputs("marks")[0], *CORPUS["chinese"]["preds"], *CORPUS["japanese"]["targets"], *CORPUS["english"]["preds"]]
    for tokenize in ("none", "13a", "zh", "intl", "char"):
        for lowercase in (False, True):
            for line in lines:
                assert _SacreBLEUTokenizer.tokenize(line, tokenize, lowercase) == JaxTokenizer.tokenize(line, tokenize, lowercase)
    with pytest.raises(ValueError, match="tokenize"):
        tm.SacreBLEUScore(tokenize="ja-mecab", device="cpu")


# ----------------------------------------------------------------------- chrF
CHRF_CASES = [
    {}, {"n_word_order": 0}, {"n_char_order": 3, "n_word_order": 1, "beta": 1.0}, {"lowercase": True},
    {"whitespace": True}, {"beta": 3.0, "n_word_order": 4},
]


@pytest.mark.parametrize("kwargs", CHRF_CASES, ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()) or "default")
@pytest.mark.parametrize("refs", [1, 3])
def test_chrf(kwargs, refs):
    _, jax_f, jax_text = _jax()
    preds, target = _corpus(40 + refs, n=12, refs=refs)
    port_v = F.chrf_score(preds, target, return_sentence_level_score=True, device="cpu", **kwargs)
    ref_v = jax_f.chrf_score(preds, target, return_sentence_level_score=True, **kwargs)
    _close(port_v[0], ref_v[0])
    _close(port_v[1], ref_v[1])
    port = tm.CHRFScore(return_sentence_level_score=True, device="cpu", **kwargs)
    ref = jax_text.CHRFScore(return_sentence_level_score=True, **kwargs)
    for p, t in _batches(preds, target):
        port.update(p, t)
        ref.update(p, t)
    for name in type(port)._TOTALS:
        _same(getattr(port, name), getattr(ref, name))
    port_v, ref_v = port.compute(), ref.compute()
    _close(port_v[0], ref_v[0])
    _close(port_v[1], ref_v[1])


def test_chrf_cjk_and_edges():
    _, jax_f, _ = _jax()
    for kind in ("chinese", "japanese"):
        data = CORPUS[kind]
        _close(F.chrf_score(data["preds"], data["targets"], device="cpu"), jax_f.chrf_score(data["preds"], data["targets"]))
    _close(F.chrf_score([""], [[""]], device="cpu"), jax_f.chrf_score([""], [[""]]))
    _close(F.chrf_score("a cat", ["a cat"], device="cpu"), jax_f.chrf_score("a cat", ["a cat"]))
    with pytest.raises(ValueError, match="n_char_order"):
        F.chrf_score(["a"], [["a"]], n_char_order=0, device="cpu")


# ------------------------------------------------------------------------ TER
TER_CASES = [
    {}, {"normalize": True}, {"no_punctuation": True}, {"lowercase": False},
    {"normalize": True, "no_punctuation": True, "lowercase": False},
]


@pytest.mark.parametrize("kwargs", TER_CASES, ids=lambda k: "-".join(k) or "default")
@pytest.mark.parametrize("refs", [1, 2])
def test_ter(kwargs, refs):
    _, jax_f, jax_text = _jax()
    preds, target = _corpus(50 + refs, n=10, refs=refs)
    port_v = F.translation_edit_rate(preds, target, return_sentence_level_score=True, device="cpu", **kwargs)
    ref_v = jax_f.translation_edit_rate(preds, target, return_sentence_level_score=True, **kwargs)
    _same(port_v[0], ref_v[0])
    _same(port_v[1], ref_v[1])
    port = tm.TranslationEditRate(return_sentence_level_score=True, device="cpu", **kwargs)
    ref = jax_text.TranslationEditRate(return_sentence_level_score=True, **kwargs)
    for p, t in _batches(preds, target, (4, 3, 3)):
        port.update(p, t)
        ref.update(p, t)
    _same(port.total_num_edits, ref.total_num_edits)
    _same(port.total_tgt_length, ref.total_tgt_length)
    port_v, ref_v = port.compute(), ref.compute()
    _same(port_v[0], ref_v[0])
    _same(port_v[1], ref_v[1])


@pytest.mark.parametrize("asian_support", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_ter_cjk(asian_support, normalize):
    _, jax_f, _ = _jax()
    for kind in ("chinese", "japanese"):
        data = CORPUS[kind]
        kwargs = {"asian_support": asian_support, "normalize": normalize, "no_punctuation": True}
        _same(
            F.translation_edit_rate(data["preds"], data["targets"], device="cpu", **kwargs),
            jax_f.translation_edit_rate(data["preds"], data["targets"], **kwargs),
        )


def test_ter_traces_and_edges():
    """The traced DP's distance and trace, and the shift search on long
    sentences (past the beam), equal JAX's."""
    from torchmetrics_tpu.functional.text.helper import _LevenshteinEditDistance as JaxLev

    from torchmetrics_tpu_torch.functional.text.helper import _LevenshteinEditDistance

    rng = np.random.RandomState(5)
    for _ in range(20):
        ref_words = _sentence(rng, 1, 70).split()
        hyp = _noisy(rng, " ".join(ref_words), 0.4).split()
        assert _LevenshteinEditDistance(ref_words)(hyp) == JaxLev(ref_words)(hyp)
    # three-word vocabularies: many equal-cost paths, so the tie order shows
    for _ in range(400):
        ref_words = [str(t) for t in rng.randint(0, 3, rng.randint(0, 12))]
        hyp = [str(t) for t in rng.randint(0, 3, rng.randint(0, 12))]
        assert _LevenshteinEditDistance(ref_words)(hyp) == JaxLev(ref_words)(hyp)
    _, jax_f, _ = _jax()
    preds = [" ".join(rng.choice(list("abc"), rng.randint(1, 14))) for _ in range(40)]
    target = [[" ".join(rng.choice(list("abc"), rng.randint(1, 14)))] for _ in range(40)]
    port_v = F.translation_edit_rate(preds, target, return_sentence_level_score=True, device="cpu")
    ref_v = jax_f.translation_edit_rate(preds, target, return_sentence_level_score=True)
    _same(port_v[0], ref_v[0])
    _same(port_v[1], ref_v[1])
    long_ref = " ".join(_sentence(rng, 60, 61) for _ in range(2))
    long_hyp = _noisy(rng, long_ref, 0.3)
    _same(F.translation_edit_rate([long_hyp], [[long_ref]], device="cpu"), jax_f.translation_edit_rate([long_hyp], [[long_ref]]))
    for preds, target in (([""], [[""]]), (["a b"], [[""]]), ([""], [["a b"]]), ([], [])):
        _same(F.translation_edit_rate(preds, target, device="cpu"), jax_f.translation_edit_rate(preds, target))
    with pytest.raises(ValueError, match="boolean"):
        F.translation_edit_rate(["a"], [["a"]], normalize=1, device="cpu")


# ---------------------------------------------------------------------- ROUGE
ROUGE_KEYS = [
    ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    ("rouge3", "rouge4", "rouge5", "rouge6", "rouge7", "rouge8", "rouge9"),
    ("rougeL",),
    "rougeLsum",
]


def _summaries(seed, n=8, refs=1):
    """Multi-sentence summaries (sentences ending in . ! or ?) and noisy
    references."""
    rng = np.random.RandomState(seed)

    def summary():
        return " ".join(_sentence(rng, 3, 10, marks=0.05) + ".!?"[rng.randint(3)] for _ in range(rng.randint(1, 4)))

    targets = [[summary()] for _ in range(n)]
    for t in targets:
        t.extend(_noisy(rng, t[0], 0.3) for _ in range(refs - 1))
    preds = [_noisy(rng, t[0], 0.3) for t in targets]
    return preds, targets


@pytest.mark.parametrize("keys", ROUGE_KEYS, ids=lambda k: k if isinstance(k, str) else "-".join(k))
@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("refs", [1, 3])
def test_rouge(keys, accumulate, refs):
    _, jax_f, jax_text = _jax()
    preds, target = _summaries(60 + refs, refs=refs)
    port_v = F.rouge_score(preds, target, accumulate=accumulate, rouge_keys=keys, device="cpu")
    ref_v = jax_f.rouge_score(preds, target, accumulate=accumulate, rouge_keys=keys)
    assert sorted(port_v) == sorted(ref_v)
    for k in ref_v:
        _close(port_v[k], ref_v[k])
        assert port_v[k].dtype == torch.float32
    port = tm.ROUGEScore(accumulate=accumulate, rouge_keys=keys, device="cpu")
    ref = jax_text.ROUGEScore(accumulate=accumulate, rouge_keys=keys)
    for p, t in _batches(preds, target, (3, 3, 2)):
        port.update(p, t)
        ref.update(p, t)
    port_v, ref_v = port.compute(), ref.compute()
    for k in ref_v:
        _close(port_v[k], ref_v[k])


def test_rouge_input_forms_and_hooks():
    _, jax_f, _ = _jax()
    cases = [
        ("the cat sat on the mat", "a cat sat on the mat"),
        ("the cat sat on the mat", ["a cat sat on the mat", "the cat is on a mat"]),
        (["the cat sat", "a dog ran"], ["a cat sat", "the dog ran fast"]),
        (["", "a b"], [[""], ["a b"]]),
    ]
    for preds, target in cases:
        port_v, ref_v = F.rouge_score(preds, target, device="cpu"), jax_f.rouge_score(preds, target)
        for k in ref_v:
            _close(port_v[k], ref_v[k])
    # CJK: the default normaliser keeps only [a-z0-9], so pass a character
    # tokenizer and an identity normaliser
    data = CORPUS["chinese"]
    kwargs = {"normalizer": lambda s: s, "tokenizer": lambda s: [c for c in s if not c.isspace()]}
    port_v = F.rouge_score(data["preds"], data["targets"], rouge_keys=("rouge1", "rouge2", "rougeL"), device="cpu", **kwargs)
    ref_v = jax_f.rouge_score(data["preds"], data["targets"], rouge_keys=("rouge1", "rouge2", "rougeL"), **kwargs)
    for k in ref_v:
        _close(port_v[k], ref_v[k])
    assert float(port_v["rouge1_fmeasure"]) > 0.3
    with pytest.raises(ValueError, match="rouge key"):
        F.rouge_score("a", "a", rouge_keys=("rouge10",), device="cpu")
    with pytest.raises(ValueError, match="nltk"):
        tm.ROUGEScore(use_stemmer=True, device="cpu")


def test_rouge_mean_is_a_float64_mean():
    """The corpus value is the float64 mean of the host floats, rounded to
    float32 once (as the JAX package forms it with ``np.mean``)."""
    preds, target = _summaries(70, n=16)
    port = tm.ROUGEScore(rouge_keys=("rouge1",), device="cpu")
    port.update(preds, target)
    assert port.rouge1_fmeasure[0].dtype == torch.float64
    from torchmetrics_tpu.functional.text.rouge import _rouge_score_update

    host = [s["fmeasure"] for s in _rouge_score_update(preds, target, [1], "best")[1]]
    assert float(port.compute()["rouge1_fmeasure"]) == float(np.float32(np.mean(host)))


# ---------------------------------------------------------------------- SQuAD
def _squad_inputs(seed, n=30):
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n):
        answers = [_sentence(rng, 1, 5, marks=0.2) for _ in range(rng.randint(1, 7))]
        pick = rng.rand()
        pred = answers[0] if pick < 0.3 else (_noisy(rng, answers[-1], 0.4) if pick < 0.8 else "The " + answers[0].upper() + ".")
        preds.append({"prediction_text": pred, "id": str(i)})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": str(i)})
    return preds, target


@pytest.mark.parametrize("seed", range(3))
def test_squad(seed):
    _, jax_f, jax_text = _jax()
    preds, target = _squad_inputs(seed)
    port_v, ref_v = F.squad(preds, target, device="cpu"), jax_f.squad(preds, target)
    for k in ("exact_match", "f1"):
        _same(port_v[k], ref_v[k])
    port, ref = tm.SQuAD(device="cpu"), jax_text.SQuAD()
    for start in range(0, len(preds), 7):
        port.update(preds[start : start + 7], target[start : start + 7])
        ref.update(preds[start : start + 7], target[start : start + 7])
    for name in ("f1_score", "exact_match", "total"):
        _same(getattr(port, name), getattr(ref, name))
    port_v, ref_v = port.compute(), ref.compute()
    for k in ("exact_match", "f1"):
        _same(port_v[k], ref_v[k])


def test_squad_unanswered_and_bad_keys():
    _, jax_f, _ = _jax()
    preds = [{"prediction_text": "a cat", "id": "1"}]
    target = [{"answers": {"text": ["a cat"]}, "id": "1"}, {"answers": {"text": ["dog"]}, "id": "2"}]
    with pytest.warns(UserWarning, match="Unanswered"):
        port_v = F.squad(preds, target, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_v = jax_f.squad(preds, target)
    for k in ("exact_match", "f1"):
        _same(port_v[k], ref_v[k])
    with pytest.raises(KeyError, match="prediction_text"):
        F.squad([{"id": "1"}], target, device="cpu")
    with pytest.raises(KeyError, match="answers"):
        F.squad(preds, [{"id": "1"}], device="cpu")


# ----------------------------------------------------------------- Perplexity
@pytest.mark.parametrize("ignore_index", [None, -100, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_perplexity(ignore_index, dtype):
    jnp, jax_f, jax_text = _jax()
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(3):
        preds = (rng.randn(2, 9, 17) * 3).astype(dtype)
        target = rng.randint(0, 17, (2, 9))
        if ignore_index is not None:
            target[rng.rand(2, 9) < 0.3] = ignore_index
        batches.append((preds, target))
    p, t = batches[0]
    _close(F.perplexity(torch.from_numpy(p), torch.from_numpy(t), ignore_index), jax_f.perplexity(jnp.asarray(p), jnp.asarray(t), ignore_index), PPL_RTOL)
    port, ref = tm.Perplexity(ignore_index=ignore_index, device="cpu"), jax_text.Perplexity(ignore_index=ignore_index)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    _same(port.count, ref.count)
    _close(port.total_log_probs, ref.total_log_probs, PPL_RTOL)
    assert port.total_log_probs.dtype == torch.float32
    _close(port.compute(), ref.compute(), PPL_RTOL)


def test_perplexity_out_of_range_target_is_nan():
    """An unmasked target outside [0, V) gives NaN in both packages; a
    masked one counts nothing and stays finite."""
    jnp, jax_f, _ = _jax()
    rng = np.random.RandomState(8)
    preds = rng.randn(1, 5, 6).astype(np.float32)
    for bad in (6, -2):
        target = np.array([[0, 1, bad, 3, 4]])
        port_v = F.perplexity(torch.from_numpy(preds), torch.from_numpy(target))
        ref_v = jax_f.perplexity(jnp.asarray(preds), jnp.asarray(target))
        assert np.isnan(float(port_v)) and np.isnan(float(ref_v))
        port_v = F.perplexity(torch.from_numpy(preds), torch.from_numpy(target), ignore_index=bad)
        _close(port_v, jax_f.perplexity(jnp.asarray(preds), jnp.asarray(target), ignore_index=bad), PPL_RTOL)


def test_perplexity_chunked_logsumexp_is_the_same(monkeypatch):
    """Row chunks of the log-sum-exp give each row the value of the
    unchunked call (bit for bit)."""
    import importlib

    module = importlib.import_module("torchmetrics_tpu_torch.functional.text.perplexity")
    rng = np.random.RandomState(9)
    logits = torch.from_numpy(rng.randn(37, 23).astype(np.float32))
    whole = module._logsumexp_rows(logits)
    monkeypatch.setattr(module, "_LSE_CHUNK_ELEMENTS", 23 * 5)
    assert torch.equal(module._logsumexp_rows(logits), whole)


def test_perplexity_checks():
    with pytest.raises(ValueError, match="3 dimensions"):
        F.perplexity(torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="equaling"):
        F.perplexity(torch.zeros(2, 3, 4), torch.zeros(2, 2, dtype=torch.int64))
    with pytest.raises(TypeError, match="floating"):
        F.perplexity(torch.zeros(2, 3, 4, dtype=torch.int64), torch.zeros(2, 3, dtype=torch.int64))
    with pytest.raises(TypeError, match="integer"):
        F.perplexity(torch.zeros(2, 3, 4), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="ignore_index"):
        tm.Perplexity(ignore_index=1.5, device="cpu")


# ------------------------------------------------------------------ devices
STRING_FUNCTIONALS = [
    ("word_error_rate", (["a b"], ["a c"])),
    ("char_error_rate", (["a b"], ["a c"])),
    ("match_error_rate", (["a b"], ["a c"])),
    ("word_information_lost", (["a b"], ["a c"])),
    ("word_information_preserved", (["a b"], ["a c"])),
    ("edit_distance", (["a b"], ["a c"])),
    ("extended_edit_distance", (["a b"], [["a c"]])),
    ("bleu_score", (["a b"], [["a c"]])),
    ("sacre_bleu_score", (["a b"], [["a c"]])),
    ("chrf_score", (["a b"], [["a c"]])),
    ("translation_edit_rate", (["a b"], [["a c"]])),
    ("rouge_score", (["a b"], [["a c"]])),
    ("squad", ([{"prediction_text": "a", "id": "1"}], [{"answers": {"text": ["a"]}, "id": "1"}])),
]


@pytest.mark.parametrize("name,args", STRING_FUNCTIONALS, ids=[s[0] for s in STRING_FUNCTIONALS])
def test_string_functionals_default_to_the_card(monkeypatch, name, args):
    """``device=None`` is the current CUDA device: without one it raises;
    ``device="cpu"`` puts the result on the CPU."""
    out = getattr(F, name)(*args, device="cpu")
    values = out.values() if isinstance(out, dict) else [out]
    assert all(v.device.type == "cpu" for v in values)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(F, name)(*args)


@pytest.mark.parametrize("cls", ["WordErrorRate", "BLEUScore", "CHRFScore", "TranslationEditRate", "ROUGEScore", "SQuAD", "Perplexity", "BERTScore", "InfoLM"])
def test_classes_default_to_the_card(monkeypatch, cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tm, cls)()


def test_inputs_on_another_device_raise():
    logits, target = torch.zeros(1, 2, 3, device="meta"), torch.zeros(1, 2, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="never copied"):
        tm.Perplexity(device="cpu").update(logits, target)
    with pytest.raises(RuntimeError, match="never copied"):
        F.perplexity(torch.zeros(1, 2, 3), target)


def test_text_paths_launch_no_kernel():
    """Text counts on the host and in plain PyTorch: no kernel of the port
    is dispatched."""
    kernels.reset_gate_log()
    preds, target = _corpus(80, n=6)
    F.word_error_rate(preds, [t[0] for t in target], device="cpu")
    F.sacre_bleu_score(preds, target, device="cpu")
    F.chrf_score(preds, target, device="cpu")
    F.rouge_score(preds, target, device="cpu")
    F.perplexity(torch.randn(2, 3, 5), torch.zeros(2, 3, dtype=torch.int64))
    assert kernels.gate_snapshot() == {}


def test_every_jax_text_name_is_exported():
    import torchmetrics_tpu.functional.text as jax_f
    import torchmetrics_tpu.text as jax_text

    assert sorted(jax_text.__all__) == sorted(tm.text.__all__)
    assert sorted(jax_f.__all__) == sorted(F.text.__all__)
    assert all(hasattr(tm, name) for name in jax_text.__all__)
    assert all(hasattr(F, name) for name in jax_f.__all__)
