"""Flat npz export and load of a parameter tree, numpy only (counterpart of
save_params_npz / load_params_npz_flat, duoformer_tcga_tpu/utils/
checkpoint.py:116-155).

The tree is the JAX package's layout (utils/convert.export_jax_params):
nested dicts and lists of numpy arrays, written as one npz entry per leaf
under its slash-joined path. Loading rebuilds nested dicts throughout;
which levels were lists is recorded beside the arrays by the serving
artifact (inference.export_serving_artifact).
"""

from __future__ import annotations

import numpy as np


def flatten(tree) -> dict:
    """{slash-joined path: numpy array} of every leaf of the tree; list
    indices and dict keys are written alike."""
    flat = {}

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk(tree)
    return flat


def save_params_npz(path: str, params) -> None:
    """Dependency-free flat export of a parameter tree."""
    np.savez(path, **flatten(params))


def load_params_npz_flat(path: str) -> dict:
    """Inverse of save_params_npz without a template: the nested tree from
    the flat slash-joined keys, as nested dicts throughout (digit keys stay
    dict keys), numpy leaves."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree
