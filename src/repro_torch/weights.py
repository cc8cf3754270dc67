"""Carry estimator and VGG16 weights from the JAX package into the port.

The port keeps the reference's parameter names, shapes and layouts (see
``estimator.model.estimator_template``), so carrying weights across is a
copy: no transpose, no reordering.

``params_from_reference`` takes the reference tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``), of the windowed
estimator or of the recurrent SSM (``estimator.ssm.ssm_template``);
``qparams_from_reference`` takes the reference's int8 serving tree
(``jax.tree.map(np.asarray, quantize_estimator(params))``), whose quantized
leaves are (int8 codes, f32 scales) tuples.
``vgg_params_from_reference`` takes the reference's flat VGG16 tree
(``{"op{i}_w": HWIO kernel or (in, out) fc weight, "op{i}_b": (C,)}``);
the forward permutes the kernels at use, so names and layouts carry over
as they are.
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


def _tensor(node, dtype, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(node)
    if arr.dtype != dtype:
        raise TypeError(f"reference leaves are {np.dtype(dtype)}, got "
                        f"{arr.dtype}")
    return torch.from_numpy(arr.copy()).to(dev)


def _convert(node, dev: torch.device, quantized: bool):
    if isinstance(node, dict):
        return {k: _convert(v, dev, quantized) for k, v in node.items()}
    if isinstance(node, tuple):
        if not quantized:
            raise TypeError("reference leaves are float32 arrays; a tuple "
                            "is a quantized leaf: use qparams_from_reference")
        if len(node) != 2:
            raise ValueError("a quantized leaf is an (int8 codes, f32 "
                             f"scales) pair, got {len(node)} arrays")
        codes = _tensor(node[0], np.int8, dev)
        scales = _tensor(node[1], np.float32, dev)
        if codes.dim() != 2 or tuple(scales.shape) != (codes.shape[0], 1):
            raise ValueError(f"codes (OUT, IN) need scales (OUT, 1), got "
                             f"{tuple(codes.shape)} and "
                             f"{tuple(scales.shape)}")
        return codes, scales
    return _tensor(node, np.float32, dev)


def params_from_reference(tree: dict, *, device="cuda") -> dict:
    """Nested dicts of arrays -> nested dicts of f32 tensors on ``device``."""
    return _convert(tree, resolve_device(device), quantized=False)


def qparams_from_reference(qtree: dict, *, device="cuda") -> dict:
    """The reference's int8 serving tree -> the port's
    (``estimator.serve.quantize_estimator``'s) on ``device``: quantized
    leaves become (int8 (OUT, IN), f32 (OUT, 1)) tensor pairs, the rest
    f32 tensors."""
    return _convert(qtree, resolve_device(device), quantized=True)


_VGG_KEY = re.compile(r"op\d+_[wb]")


def vgg_params_from_reference(tree: dict, *, device="cuda") -> dict:
    """The reference's ``init_vgg`` tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> {name: f32 tensor} on
    ``device``, names and layouts unchanged."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        if not _VGG_KEY.fullmatch(name):
            raise ValueError(f"not a VGG parameter name: {name!r}")
        out[name] = _tensor(leaf, np.float32, dev)
    return out


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
