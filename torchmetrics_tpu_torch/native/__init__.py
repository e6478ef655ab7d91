"""The port's host C++ libraries, loaded with ctypes: the text metrics'
``edit_distance.cpp`` and PESQ's ``pesq.cpp``.

``edit_distance.cpp`` holds the batched Levenshtein distance, the longest
common subsequence and ROUGE-N's clipped n-gram overlap over id-mapped token
sequences. ``pesq.cpp`` holds the ITU-T P.862 pipeline (level alignment,
band-limit filtering, delay estimation, the Bark-loudness perceptual model
and the P.862.1/P.862.2 MOS-LQO mapping; its header says what it
simplifies). Both run on the host, never on the card: strings are host data,
and PESQ's alignment and perceptual model are sequential float64 code.

Each source is compiled on its own with ``g++ -O3 -shared -fPIC`` at first
use into the package's gitignored ``_build/`` directory, under a name of its
own hashed on that source and the toolchain (``g++ --version`` and
:data:`CXX_FLAGS`: ``libtm_text_native-<hash>.so``, ``libtm_pesq-<hash>.so``),
so an edited source or another compiler rebuilds and an unchanged build is
reused, and neither library's build touches the other's. A build goes to a
process-unique temporary file that is renamed over the final name, so
concurrent processes never see a half-written library, and leaves a sidecar
beside it: a library whose sidecar does not vouch for it (truncated,
zeroed, flipped, replaced) is warned about, deleted and rebuilt
(``native/libstore.py``). Where the text
library cannot be built, every text entry point falls back to its
pure-Python body with a ``RuntimeWarning`` (:func:`native_available` says
which one runs). PESQ has no pure-Python body: :func:`pesq_batch` returns
None and the metric raises with the compiler's output
(:func:`pesq_build_error`).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from collections import Counter
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from torchmetrics_tpu_torch.native import libstore

SOURCE = Path(__file__).resolve().parent / "edit_distance.cpp"
PESQ_SOURCE = Path(__file__).resolve().parent / "pesq.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_SYMBOLS = ("tm_levenshtein", "tm_levenshtein_batch", "tm_lcs", "tm_lcs_batch", "tm_ngram_hits_batch")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()
_PESQ_LIB: Optional[ctypes.CDLL] = None
_PESQ_TRIED = False
_PESQ_ERROR: Optional[str] = None


def toolchain() -> str:
    """What a host library's bytes depend on besides its source: the
    ``g++ --version`` output and :data:`CXX_FLAGS`."""
    return libstore.toolchain(CXX, CXX_FLAGS, "host")


def _hashed(source: Path, stem: str) -> Path:
    return BUILD_DIR / libstore.library_name(stem, [source], toolchain())


def library_path() -> Path:
    """Where the library built from ``edit_distance.cpp`` lives (hashed on
    the source and the toolchain)."""
    return _hashed(SOURCE, "libtm_text_native")


def pesq_library_path() -> Path:
    """Where the library built from ``pesq.cpp`` lives (hashed on that
    source alone and the toolchain)."""
    return _hashed(PESQ_SOURCE, "libtm_pesq")


def _build(source: Path, out: Path) -> Path:
    """Compile ``source`` into ``out`` unless a library its sidecar vouches
    for is there already (a damaged one is discarded first), all under the
    library's build lock (``libstore.locked``). Raises
    ``subprocess.CalledProcessError`` (with the compiler's output) or
    ``FileNotFoundError`` (no ``g++``)."""
    tool = toolchain()
    with libstore.locked(out):
        if libstore.usable(out, tool):
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                [CXX, *CXX_FLAGS, str(source), "-o", str(tmp)],
                check=True, capture_output=True, text=True, timeout=120,
            )
            os.replace(tmp, out)  # atomic: a concurrent reader sees all or nothing
            libstore.seal(out, tool)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def build() -> Path:
    """Compile the text library if it is not built yet and return its path
    (raises as :func:`_build`)."""
    return _build(SOURCE, library_path())


def build_pesq() -> Path:
    """Compile the PESQ library if it is not built yet and return its path
    (raises as :func:`_build`)."""
    return _build(PESQ_SOURCE, pesq_library_path())


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.tm_levenshtein.restype = i64
    lib.tm_levenshtein.argtypes = [p, i64, p, i64, i64]
    lib.tm_levenshtein_batch.restype = None
    lib.tm_levenshtein_batch.argtypes = [p, p, p, p, i64, i64, p]
    lib.tm_lcs.restype = i64
    lib.tm_lcs.argtypes = [p, i64, p, i64]
    lib.tm_lcs_batch.restype = None
    lib.tm_lcs_batch.argtypes = [p, p, p, p, i64, p]
    lib.tm_ngram_hits_batch.restype = None
    lib.tm_ngram_hits_batch.argtypes = [p, p, p, p, i64, i64, p, p, p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library once a process; None when it
    cannot be built, after one warning."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = libstore.open_library(build)
            if not all(hasattr(lib, sym) for sym in _SYMBOLS):
                raise OSError(f"{library_path().name} lacks one of {_SYMBOLS}")
            _LIB = _declare(lib)
        except (OSError, subprocess.SubprocessError) as err:
            detail = getattr(err, "stderr", None) or err
            warnings.warn(
                f"torchmetrics_tpu_torch: the text metrics' native library did not build ({detail});"
                " the pure-Python edit distance, LCS and n-gram bodies run instead",
                RuntimeWarning,
                stacklevel=3,
            )
            _LIB = None
        return _LIB


def native_available() -> bool:
    """Whether the C++ library is built and loaded (else the pure-Python
    bodies serve every entry point)."""
    return _load() is not None


def _tokens_to_ids(*sequences: Sequence) -> List[np.ndarray]:
    """Map arbitrary hashable tokens to one shared int64 id space.

    ``np.unique(return_inverse=True)`` labels them (the ids are only tested
    for equality, so their order does not matter); mixed or unorderable
    token types take a dict walk instead.
    """
    lens = [len(s) for s in sequences]
    flat: List = [t for s in sequences for t in s]
    if not flat:
        return [np.zeros(0, dtype=np.int64) for _ in sequences]
    try:
        if len(set(map(type, flat))) > 1:
            raise TypeError  # mixed types: np.asarray would coerce (1 -> "1")
        arr = np.asarray(flat)
        if arr.ndim != 1:  # equal-length tuple tokens coerce to 2-D
            raise TypeError
        inv = np.unique(arr, return_inverse=True)[1].astype(np.int64, copy=False)
    except (TypeError, ValueError):
        vocab: dict = {}
        inv = np.fromiter((vocab.setdefault(tok, len(vocab)) for tok in flat), dtype=np.int64, count=len(flat))
    out = []
    start = 0
    for n in lens:
        out.append(inv[start : start + n])
        start += n
    return out


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _py_edit_distance(a: Sequence, b: Sequence, substitution_cost: int = 1) -> int:
    """Two-row Levenshtein DP in Python (the native body's plain version)."""
    prev = list(range(len(b) + 1))
    for i, p_tok in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, r_tok in enumerate(b, start=1):
            sub = prev[j - 1] + (substitution_cost if p_tok != r_tok else 0)
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return prev[-1]


def edit_distance(a: Sequence, b: Sequence, substitution_cost: int = 1) -> int:
    """Levenshtein distance of two token sequences."""
    lib = _load()
    if lib is None:
        return _py_edit_distance(a, b, substitution_cost)
    ia, ib = _tokens_to_ids(a, b)
    return int(lib.tm_levenshtein(_ptr(ia), len(ia), _ptr(ib), len(ib), substitution_cost))


def _py_lcs(a: Sequence, b: Sequence) -> int:
    """Two-row LCS DP in Python (the native body's plain version)."""
    prev = [0] * (len(b) + 1)
    for p_tok in a:
        cur = [0] * (len(b) + 1)
        for j, r_tok in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if p_tok == r_tok else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def lcs_length(a: Sequence, b: Sequence) -> int:
    """Length of the longest common subsequence of two token sequences."""
    if not a or not b:
        return 0
    lib = _load()
    if lib is None:
        return _py_lcs(a, b)
    ia, ib = _tokens_to_ids(a, b)
    return int(lib.tm_lcs(_ptr(ia), len(ia), _ptr(ib), len(ib)))


def _flatten_pairs(pairs: Sequence[Tuple[Sequence, Sequence]]) -> Tuple[np.ndarray, ...]:
    """The batch entry points' layout: ``(a_flat, a_offsets, b_flat,
    b_offsets)`` in one shared id space, offsets of length ``len(pairs) + 1``."""
    ids = _tokens_to_ids(*(seq for pair in pairs for seq in pair))
    a_seqs, b_seqs = ids[0::2], ids[1::2]
    a_flat = np.concatenate(a_seqs) if a_seqs else np.zeros(0, dtype=np.int64)
    b_flat = np.concatenate(b_seqs) if b_seqs else np.zeros(0, dtype=np.int64)
    a_off = np.zeros(len(pairs) + 1, dtype=np.int64)
    b_off = np.zeros(len(pairs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in a_seqs], out=a_off[1:])
    np.cumsum([len(s) for s in b_seqs], out=b_off[1:])
    return a_flat, a_off, b_flat, b_off


def batch_edit_distance(pairs: Sequence[Tuple[Sequence, Sequence]], substitution_cost: int = 1) -> np.ndarray:
    """Edit distances of a batch of (prediction_tokens, reference_tokens)
    pairs, one native call for the batch (int64)."""
    lib = _load()
    if lib is None:
        return np.asarray([_py_edit_distance(a, b, substitution_cost) for a, b in pairs], dtype=np.int64)
    a_flat, a_off, b_flat, b_off = _flatten_pairs(pairs)
    out = np.zeros(len(pairs), dtype=np.int64)
    lib.tm_levenshtein_batch(
        _ptr(a_flat), _ptr(a_off), _ptr(b_flat), _ptr(b_off), len(pairs), substitution_cost, _ptr(out)
    )
    return out


def batch_lcs(pairs: Sequence[Tuple[Sequence, Sequence]]) -> np.ndarray:
    """LCS lengths of a batch of token-sequence pairs, one native call (int64)."""
    lib = _load()
    if lib is None:
        return np.asarray([_py_lcs(a, b) for a, b in pairs], dtype=np.int64)
    a_flat, a_off, b_flat, b_off = _flatten_pairs(pairs)
    out = np.zeros(len(pairs), dtype=np.int64)
    lib.tm_lcs_batch(_ptr(a_flat), _ptr(a_off), _ptr(b_flat), _ptr(b_off), len(pairs), _ptr(out))
    return out


def _py_ngram_hits(a: Sequence, b: Sequence, n: int) -> Tuple[int, int, int]:
    """Clipped n-gram overlap and both n-gram totals in Python (the native
    body's plain version)."""
    ca = Counter(tuple(a[i : i + n]) for i in range(len(a) - n + 1))
    cb = Counter(tuple(b[i : i + n]) for i in range(len(b) - n + 1))
    hits = sum(min(ca[g], cb[g]) for g in ca if g in cb)
    return hits, sum(ca.values()), sum(cb.values())


def batch_ngram_hits_multi(pairs: Sequence[Tuple[Sequence, Sequence]], ns: Sequence[int]) -> dict:
    """Clipped n-gram overlap of a batch of token-sequence pairs for several
    ``n`` at once: the pairs are id-mapped once, then one native call an
    ``n``. Returns ``{n: (hits, a_ngram_counts, b_ngram_counts)}``, int64
    arrays with one entry a pair."""
    lib = _load()
    if lib is None:
        out = {}
        for n in ns:
            res = [_py_ngram_hits(a, b, n) for a, b in pairs]
            cols = list(zip(*res)) if res else ([], [], [])
            out[n] = tuple(np.asarray(c, dtype=np.int64) for c in cols)
        return out
    a_flat, a_off, b_flat, b_off = _flatten_pairs(pairs)
    out = {}
    for n in ns:
        hits, a_cnt, b_cnt = (np.zeros(len(pairs), dtype=np.int64) for _ in range(3))
        lib.tm_ngram_hits_batch(
            _ptr(a_flat), _ptr(a_off), _ptr(b_flat), _ptr(b_off), len(pairs), n,
            _ptr(hits), _ptr(a_cnt), _ptr(b_cnt),
        )
        out[n] = (hits, a_cnt, b_cnt)
    return out


def batch_ngram_hits(pairs: Sequence[Tuple[Sequence, Sequence]], n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-``n`` form of :func:`batch_ngram_hits_multi`."""
    return batch_ngram_hits_multi(pairs, [n])[n]


def _load_pesq() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the PESQ library once a process; None when
    it cannot be built, with the reason kept for :func:`pesq_build_error`."""
    global _PESQ_LIB, _PESQ_TRIED, _PESQ_ERROR
    with _LOCK:
        if _PESQ_TRIED:
            return _PESQ_LIB
        _PESQ_TRIED = True
        try:
            lib = libstore.open_library(build_pesq)
            d, i64 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64
            lib.tm_pesq.restype = ctypes.c_double
            lib.tm_pesq.argtypes = [d, d, i64, i64, ctypes.c_int32]
            lib.tm_pesq_batch.restype = None
            lib.tm_pesq_batch.argtypes = [d, d, i64, i64, i64, ctypes.c_int32, d]
            _PESQ_LIB = lib
        except (OSError, subprocess.SubprocessError, AttributeError) as err:
            _PESQ_ERROR = str(getattr(err, "stderr", None) or err)
            _PESQ_LIB = None
        return _PESQ_LIB


def pesq_available() -> bool:
    """Whether the PESQ library is built and loaded."""
    return _load_pesq() is not None


def pesq_build_error() -> Optional[str]:
    """Why the PESQ library could not be built or loaded (the compiler's
    output), or None."""
    _load_pesq()
    return _PESQ_ERROR


def pesq_batch(ref: np.ndarray, deg: np.ndarray, fs: int, wideband: bool) -> Optional[np.ndarray]:
    """MOS-LQO of ``(B, time)`` float64 reference/degraded pairs, one native
    call for the batch (float64). None when the library is unavailable: PESQ
    has no pure-Python body. A signal the library refuses (``fs`` outside
    {8000, 16000}, or too short) scores NaN, with one ``RuntimeWarning``."""
    lib = _load_pesq()
    if lib is None:
        return None
    ref = np.ascontiguousarray(ref, dtype=np.float64)
    deg = np.ascontiguousarray(deg, dtype=np.float64)
    batch, n = ref.shape
    out = np.empty(batch, dtype=np.float64)
    d = ctypes.POINTER(ctypes.c_double)
    lib.tm_pesq_batch(ref.ctypes.data_as(d), deg.ctypes.data_as(d), batch, n, fs, 1 if wideband else 0, out.ctypes.data_as(d))
    if (out < 0).any():
        warnings.warn(
            "PESQ kernel reported errors for some signals (fs not in {8000,16000} or signal too"
            " short); returning NaN for those entries.",
            RuntimeWarning,
        )
        out = np.where(out < 0, np.nan, out)
    return out
