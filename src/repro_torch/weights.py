"""Carry estimator weights from the JAX package into the port.

The port keeps the reference's parameter names, shapes and layouts (see
``estimator.model.estimator_template``), so carrying weights across is a
copy: no transpose, no reordering.

``params_from_reference`` takes the reference tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``).
``load_reference_checkpoint`` reads the reference checkpoint format
directly — a ``manifest.json`` plus one ``.npy`` per leaf, keyed by
``jax.tree_util.keystr`` paths such as ``['lstm']['wx']`` — without JAX.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device

_KEY = re.compile(r"\['([^']*)'\]")


def params_from_reference(tree: dict, *, device="cuda") -> dict:
    """Nested dicts of arrays -> nested dicts of f32 tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype != np.float32:
            raise TypeError(f"reference leaves are float32, got {arr.dtype}")
        return torch.from_numpy(arr.copy()).to(dev)

    return conv(tree)


def load_reference_checkpoint(step_dir, *, device="cuda") -> dict:
    """Parameters from one reference checkpoint step directory
    (``<ckpt_dir>/step_XXXXXXXX``) of an estimator parameter tree."""
    step_dir = Path(step_dir)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    tree: dict = {}
    for leaf in manifest["leaves"]:
        path = _KEY.findall(leaf["key"])
        if not path or "".join(f"['{p}']" for p in path) != leaf["key"]:
            raise ValueError(f"not a nested-dict key path: {leaf['key']!r}")
        arr = np.load(step_dir / leaf["file"], allow_pickle=False)
        if list(arr.shape) != leaf["shape"] or str(arr.dtype) != leaf["dtype"]:
            raise ValueError(f"{leaf['file']} does not match its manifest "
                             f"entry {leaf}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return params_from_reference(tree, device=device)
