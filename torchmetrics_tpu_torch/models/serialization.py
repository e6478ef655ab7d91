"""Flat npz (de)serialization for model parameter trees.

A parameter tree (nested dicts and lists of arrays, as the JAX package's flax
models keep them) is stored as one ``.npz`` with ``/``-joined dict paths as
keys. The port reads such a bundle with :func:`load_npz_tree` and turns an
InceptionV3 tree into a PyTorch state dict with
``models.inception.params_from_jax``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list parameter tree -> flat ``{"a/b/c": array}`` mapping.

    List nodes (e.g. the LPIPS ``lins`` head list) flatten under ``#{i}``
    segment names so :func:`unflatten_tree` can rebuild them as lists."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_tree(v, f"{prefix}#{i}/"))
    else:
        flat[prefix.rstrip("/")] = np.asarray(tree)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree`."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def _listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [_listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}

    return _listify(tree)


def load_npz_tree(path: str) -> Dict[str, Any]:
    """Load a ``flatten_tree`` npz bundle back into a parameter tree."""
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
