"""The port's native text library (``torchmetrics_tpu_torch/native``) against
its pure-Python bodies and against the JAX package's library on the same
pairs.

Every count (edit distances at several substitution costs, LCS lengths,
clipped n-gram hits and totals) must match bit for bit. The port builds its
own library from its own copy of ``edit_distance.cpp`` into
``torchmetrics_tpu_torch/_build/`` under a name of its own, never into the
JAX package's per-user cache; where it cannot build, every entry point warns
once and serves the pure-Python body.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torchmetrics_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent
VOCAB = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", ",", ".", "Der", "Hund", "lief", "über", "猫", "12", "x"]


def _jax_native():
    import torchmetrics_tpu.native as jax_native

    return jax_native


def _pairs(seed: int, n: int = 40, max_len: int = 14):
    """Seeded token-sequence pairs: the second a noisy copy of the first
    (substitutions, insertions, deletions, a swapped span), some empty."""
    rng = np.random.RandomState(seed)
    pairs = []
    for k in range(n):
        a = [VOCAB[i] for i in rng.randint(0, len(VOCAB), rng.randint(0, max_len + 1))]
        b = list(a)
        for _ in range(rng.randint(0, 4)):
            op = rng.randint(0, 4)
            if op == 0 and b:
                b[rng.randint(0, len(b))] = VOCAB[rng.randint(0, len(VOCAB))]
            elif op == 1:
                b.insert(rng.randint(0, len(b) + 1), VOCAB[rng.randint(0, len(VOCAB))])
            elif op == 2 and b:
                del b[rng.randint(0, len(b))]
            elif op == 3 and len(b) > 3:
                i = rng.randint(0, len(b) - 2)
                b[i : i + 2] = b[i : i + 2][::-1]
        if k % 9 == 0:
            b = []
        pairs.append((a, b))
    return pairs


def test_the_library_is_the_ports_own_build():
    path = native.library_path()
    assert path.parent == REPO / "torchmetrics_tpu_torch" / "_build"
    assert path.name.startswith("libtm_text_native-") and path.suffix == ".so"
    assert native.native_available()
    assert path.exists()


def test_the_source_is_a_copy_of_the_jax_packages():
    """The port carries its own copy of the C++ source; the two stay
    byte-equal. ``pesq.cpp`` is copied too and built as a library of its own
    (``tests/test_torch_audio_native.py``), which the text library's hash
    does not read."""
    ours = REPO / "torchmetrics_tpu_torch" / "native" / "edit_distance.cpp"
    assert ours.read_bytes() == (REPO / "torchmetrics_tpu" / "native" / "edit_distance.cpp").read_bytes()
    assert native.SOURCE == ours and native.PESQ_SOURCE != native.SOURCE


def test_building_never_touches_the_jax_cache(tmp_path):
    """In a fresh process with its own cache home, the port's library loads
    and no ``tm_tpu_native`` cache appears (the JAX loader's)."""
    env = dict(os.environ, HOME=str(tmp_path), XDG_CACHE_HOME=str(tmp_path / "cache"))
    code = (
        "import sys\n"
        "from torchmetrics_tpu_torch import native\n"
        "assert native.native_available()\n"
        "print(native.batch_edit_distance([('a b c'.split(), 'a c'.split())]).tolist())\n"
        "assert not any(m.split('.')[0] == 'torchmetrics_tpu' for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[1]"
    assert not (tmp_path / "cache" / "tm_tpu_native").exists()
    assert not (tmp_path / ".cache" / "tm_tpu_native").exists()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cost", [0, 1, 2, 3])
def test_edit_distances_bit_for_bit(seed, cost):
    pairs = _pairs(seed)
    want = [native._py_edit_distance(a, b, cost) for a, b in pairs]
    assert native.batch_edit_distance(pairs, cost).tolist() == want
    assert [native.edit_distance(a, b, cost) for a, b in pairs] == want
    assert _jax_native().batch_edit_distance(pairs, cost).tolist() == want
    assert native.batch_edit_distance(pairs, cost).dtype == np.int64


@pytest.mark.parametrize("seed", range(4))
def test_lcs_bit_for_bit(seed):
    pairs = _pairs(seed)
    want = [native._py_lcs(a, b) for a, b in pairs]
    assert native.batch_lcs(pairs).tolist() == want
    assert [native.lcs_length(a, b) for a, b in pairs] == want
    assert [_jax_native().lcs_length(a, b) for a, b in pairs] == want


@pytest.mark.parametrize("seed", range(4))
def test_ngram_hits_bit_for_bit(seed):
    pairs = _pairs(seed)
    ns = [1, 2, 3, 4, 9]
    ours = native.batch_ngram_hits_multi(pairs, ns)
    theirs = _jax_native().batch_ngram_hits_multi(pairs, ns)
    for n in ns:
        want = [native._py_ngram_hits(a, b, n) for a, b in pairs]
        got = list(zip(*(col.tolist() for col in ours[n])))
        assert got == want
        assert [c.tolist() for c in theirs[n]] == [c.tolist() for c in ours[n]]
        assert [c.tolist() for c in native.batch_ngram_hits(pairs, n)] == [c.tolist() for c in ours[n]]


@pytest.mark.parametrize(
    "a,b",
    [
        ([], []),
        ([], ["x"]),
        (list("kitten"), list("sitting")),
        ([1, "1", 1.0], ["1", 1]),  # mixed types: ids by a dict walk, 1 == 1.0 as Python has it
        ([("a", "b"), ("c", "d")], [("a", "b")]),  # tuple tokens
        (["猫", "が", "座った"], ["猫", "座った"]),
    ],
)
def test_odd_tokens(a, b):
    for cost in (1, 2):
        assert native.edit_distance(a, b, cost) == native._py_edit_distance(a, b, cost)
        assert native.edit_distance(a, b, cost) == _jax_native().edit_distance(a, b, cost)
    assert native.lcs_length(a, b) == native._py_lcs(a, b)
    assert native.batch_lcs([(a, b)]).tolist() == [native._py_lcs(a, b)]
    ids = native._tokens_to_ids(a, b)
    jax_ids = _jax_native()._tokens_to_ids(a, b)
    flat, jax_flat = np.concatenate(ids), np.concatenate(jax_ids)
    # the same equality structure (the ids themselves need not match)
    assert np.array_equal(flat[:, None] == flat[None, :], jax_flat[:, None] == jax_flat[None, :])


def test_empty_batches():
    assert native.batch_edit_distance([]).shape == (0,)
    assert native.batch_lcs([]).shape == (0,)
    assert all(c.shape == (0,) for c in native.batch_ngram_hits([], 2))


def test_pure_python_bodies_serve_without_the_library(monkeypatch):
    pairs = _pairs(7)
    want_ed = native.batch_edit_distance(pairs, 2).tolist()
    want_lcs = native.batch_lcs(pairs).tolist()
    want_hits = [c.tolist() for c in native.batch_ngram_hits(pairs, 2)]
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.batch_edit_distance(pairs, 2).tolist() == want_ed
    assert native.batch_lcs(pairs).tolist() == want_lcs
    assert [c.tolist() for c in native.batch_ngram_hits(pairs, 2)] == want_hits
    assert not native.native_available()


def test_a_failed_build_warns_and_falls_back(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    with pytest.warns(RuntimeWarning, match="did not build"):
        assert native._load() is None
    assert native.edit_distance(list("ab"), list("b")) == 1
    assert not list((tmp_path / "_build").glob("*.so"))
