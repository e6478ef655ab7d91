"""Bit-exact state fingerprints (the start of the JAX package's ``integrity.py``).

A fingerprint is an order-insensitive fold of a leaf's raw 32-bit words: its
XOR and its wrapping uint32 sum. Snapshot manifests carry one per leaf
(``io/checkpoint.py``), and a restore re-fingerprints the state the metric
installed against them, so a flip on the install path (the host-to-device
copy, an aliasing or cast bug) cannot restore silently. The fold is the JAX
package's, so a manifest written by either package verifies in the other.

The device-side fold, the audits and the replica checks of the JAX module
are not ported yet.
"""
from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["host_leaf_fingerprint"]


def host_leaf_fingerprint(arr: Any) -> np.ndarray:
    """``uint32[2]`` = (XOR, wrapping sum) over the leaf's 32-bit words.

    Leaves of 4 or 8 bytes an element are read as uint32 words (an 8-byte
    element gives two); 1- and 2-byte elements (and bools) are widened to
    one word each.

    >>> host_leaf_fingerprint(np.array([1, 2, 3], np.int32)).tolist()
    [0, 6]
    """
    a = np.ascontiguousarray(arr)
    if a.dtype == np.bool_:
        u = a.astype(np.uint32).reshape(-1)
    elif a.dtype.itemsize >= 4:
        u = a.reshape(-1).view(np.uint32)
    else:
        narrow = np.uint8 if a.dtype.itemsize == 1 else np.uint16
        u = a.reshape(-1).view(narrow).astype(np.uint32)
    if u.size == 0:
        return np.zeros((2,), np.uint32)
    xor = np.bitwise_xor.reduce(u)
    total = np.sum(u, dtype=np.uint32)
    return np.array([xor, total], np.uint32)
