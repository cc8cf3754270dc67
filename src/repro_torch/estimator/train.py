"""Training loops, inference helpers and metrics for the throughput
estimators.

Both families train through one step factory each, with the reference's
contract: the dataset goes to the device once, and a step ships only its
``(batch,)`` index vector, gathered on the device with ``index_select``.

  * the windowed LSTM+CNN estimator: ``estimator_loss``,
    ``make_train_step`` (the host hands the batch in),
    ``make_indexed_step`` (the gather on the device; a field may be the
    int8 ``(q, scales)`` rows of a replay ring) and ``train_estimator``;
  * the recurrent SSM estimator: ``ssm_step_loss`` and
    ``make_indexed_step_ssm`` (one stored-state step, truncated BPTT 1),
    ``ssm_seq_loss``, ``make_indexed_seq_step`` and ``train_ssm``
    (teacher-forced sequences), and ``ssm_predict``.

Gradients come from autograd (``loss_and_grads``); the update is the
reference's AdamW (``repro_torch.optim``). Dropout masks are explicit
bool tensors: the trainer draws them from its own ``torch.Generator``
on the training device. The reference cannot differentiate through its
``ssd`` kernel, so the sequence trainers refuse ``SSMConfig(use_kernel=
True)``; ``ssm_predict`` runs whatever config it is given.
``fwd``, ``predict`` and ``r2_rmse`` serve the fleet engine and the
evaluations.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.estimator.model import (EstimatorConfig, as_f32,
                                         estimator_forward,
                                         estimator_forward_train, full_f32,
                                         init_estimator)
from repro_torch.estimator.ssm import (SSMConfig, init_ssm, seq_core,
                                       ssm_forward_seq, step_core)
from repro_torch.optim import AdamW, tree_leaves

F32 = torch.float32

# the four fields every estimator batch carries (gen_dataset also emits
# "scenario", which is metadata, not a model input)
BATCH_KEYS = ("kpms", "iq", "alloc", "tp")

# the recurrent estimator's replay rows: the pre-report state, the report
# features, and the label (truncated BPTT 1: the stored state is a
# constant, gradients flow through the one stored step)
SSM_BATCH_KEYS = ("state", "feats", "tp")


def _not_ported(arg: str, item: str):
    return NotImplementedError(
        f"{arg} is not ported to repro_torch yet: ROADMAP.md module queue "
        f"item {item}")


def r2_rmse(pred: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    pred, y = np.asarray(pred, float), np.asarray(y, float)
    ss_res = float(np.sum((pred - y) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-9
    return 1.0 - ss_res / ss_tot, float(np.sqrt(np.mean((pred - y) ** 2)))


def _rebuild(tree, leaves):
    """``tree`` with its leaves (in ``tree_leaves`` order) replaced."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(go(v) for v in node)
        return next(it)

    return go(tree)


def loss_and_grads(loss_fn, params):
    """``jax.value_and_grad`` for a tree of tensors: (the loss, detached,
    and a tree of gradients shaped as ``params``). Full f32 on the card
    for the forward and the backward alike."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with full_f32(leaves[0].device):
        loss = loss_fn(_rebuild(params, leaves))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _rebuild(params, grads)


def estimator_loss(e: EstimatorConfig, params: dict, batch: dict,
                   keep=None) -> torch.Tensor:
    """MSE (Mbps^2) of the training-mode forward on one minibatch; ``keep``
    is the CNN branch's (B, hidden) bool dropout mask, or None."""
    pred = estimator_forward_train(e, params, batch["kpms"], batch["iq"],
                                   batch["alloc"], keep)
    return torch.mean((pred - batch["tp"]) ** 2)


def make_train_step(e: EstimatorConfig, opt: AdamW):
    """Explicit-minibatch AdamW step: the host hands the batch in, on the
    parameters' device. ``step(params, opt_state, batch, keep) ->
    (params, opt_state, loss)``: the reference semantics of
    :func:`make_indexed_step` (the same loss and update; the indexed path
    only moves the gather onto the device)."""
    def step(params, opt_state, batch, keep=None):
        loss, grads = loss_and_grads(
            lambda p: estimator_loss(e, p, batch, keep), params)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def gather_rows(v, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a device-resident field: a tensor, or the int8
    replay ring's ``(q, per-row scales)`` pair, of which only the selected
    rows are dequantized (``q * scale`` in f32)."""
    if isinstance(v, tuple):
        q, s = v
        sb = s.index_select(0, idx)
        return (q.index_select(0, idx).to(F32)
                * sb.reshape((sb.shape[0],) + (1,) * (q.dim() - 1)))
    return v.index_select(0, idx)


def make_indexed_step(e: EstimatorConfig, opt: AdamW, *, mesh=None):
    """The offline (and online) step factory, the gather by index on the
    device.

    Returns ``step(params, opt_state, data, idx, keep) -> (params,
    opt_state, loss)``: ``data`` is the device-resident dataset (or replay
    buffer) keyed by :data:`BATCH_KEYS`, a field a tensor or an int8
    ``(q, scales)`` pair; ``idx`` a ``(batch,)`` integer row selection
    (the only per-step transfer); ``keep`` the dropout mask or None.
    ``mesh`` (a data-sharded deployment) is not ported yet."""
    if mesh is not None:
        raise _not_ported("mesh (a sharded training step)", "12")

    def step(params, opt_state, data, idx, keep=None):
        dev = tree_leaves(params)[0].device
        idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int64)
        batch = {k: gather_rows(data[k], idx) for k in BATCH_KEYS}
        loss, grads = loss_and_grads(
            lambda p: estimator_loss(e, p, batch, keep), params)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def to_device(data: dict, keys, dev: torch.device) -> dict:
    """``data[k]`` for ``k`` in ``keys`` on ``dev``: numpy arrays and
    tensors as f32, an int8 ``(q, scales)`` pair as it is."""
    out = {}
    for k in keys:
        v = data[k]
        if isinstance(v, tuple):
            out[k] = tuple(torch.as_tensor(a).to(dev) for a in v)
        else:
            out[k] = as_f32(v, dev)
    return out


def train_estimator(e: EstimatorConfig, data: dict, *, steps: int = 300,
                    batch: int = 32, lr: float = 1e-3, seed: int = 0,
                    log_every: int = 50, eval_data: dict | None = None,
                    device="cuda"):
    """AdamW on the windowed estimator: ``(params, history, metrics)``,
    ``history`` the ``(step, loss)`` pairs at every ``log_every`` steps
    and the last, ``metrics`` ``r2_rmse`` on ``eval_data`` or None.

    As the reference: the init from ``seed`` (``init_estimator`` of a
    ``torch.Generator``), the minibatch indices from
    ``np.random.default_rng(seed)``, so both packages see the same
    minibatches; the dropout masks from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    params = init_estimator(e, torch.Generator().manual_seed(seed),
                            device=dev)
    opt = AdamW(lr=lr, weight_decay=1e-4, clip_norm=1.0)
    opt_state = opt.init(params)
    step_fn = make_indexed_step(e, opt)
    n = len(data["tp"])
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # the dataset goes to the device once; a step ships its index vector
    data_dev = to_device(data, BATCH_KEYS, dev)
    history = []
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, batch))
        keep = None
        if e.dropout:
            keep = torch.rand((batch, e.hidden), generator=gen,
                              device=dev) < 1 - e.dropout
        params, opt_state, loss = step_fn(params, opt_state, data_dev, idx,
                                          keep)
        if i % log_every == 0 or i == steps - 1:
            history.append((i, float(loss)))
    metrics = None
    if eval_data is not None:
        pred = predict(e, params, eval_data, device=dev)
        metrics = r2_rmse(pred, eval_data["tp"])
    return params, history, metrics


# ------------------------------------------------- recurrent (SSM) paths
def _check_differentiable(c: SSMConfig) -> None:
    """The reference cannot differentiate through its ``ssd`` kernel
    (``jax.grad`` of ``ssd_mixer(use_kernel=True)`` fails in Pallas's JVP
    rule), so its sequence trainers work only with the plain recurrence;
    the port refuses the kernel config outright."""
    if c.use_kernel:
        raise ValueError(
            "sequence training differentiates the ssd mixer, and the "
            "reference cannot differentiate through its ssd kernel; train "
            "with SSMConfig(use_kernel=False) and evaluate with "
            "use_kernel=True if you like")


def ssm_step_loss(c: SSMConfig, params: dict, batch: dict) -> torch.Tensor:
    """MSE (Mbps^2) of one stored-state replay step (the online loss).

    Each row carries the recurrent state as it was before the report, a
    constant under the gradient (``detach``), so adaptation backprops
    through exactly one recurrence step (truncated BPTT, length 1)."""
    _, fc = step_core(c, params, batch["state"].detach(), batch["feats"])
    return torch.mean((fc[..., 0] - batch["tp"]) ** 2)


def make_indexed_step_ssm(c: SSMConfig, opt: AdamW, *, mesh=None):
    """:func:`make_indexed_step` for the recurrent estimator, over
    :data:`SSM_BATCH_KEYS`: ``step(params, opt_state, data, idx)`` (the
    SSM has no dropout). Step mode never runs the ``ssd`` kernel, so any
    ``use_kernel`` trains."""
    if mesh is not None:
        raise _not_ported("mesh (a sharded training step)", "12")

    def step(params, opt_state, data, idx):
        dev = tree_leaves(params)[0].device
        idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int64)
        batch = {k: data[k].index_select(0, idx) for k in SSM_BATCH_KEYS}
        loss, grads = loss_and_grads(
            lambda p: ssm_step_loss(c, p, batch), params)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def ssm_seq_loss(c: SSMConfig, params: dict, batch: dict) -> torch.Tensor:
    """Teacher-forced sequence MSE: the whole (B, S) report trace through
    one chunked ``ssd_mixer`` pass, the labels on the last ``T`` steps
    (``S - T`` warm-up reports precede the first label, the fleet
    engine's WINDOW offset)."""
    _check_differentiable(c)
    fc, _ = seq_core(c, params, batch["feats"])
    t = batch["tp"].shape[1]
    off = batch["feats"].shape[1] - t
    return torch.mean((fc[:, off - 1:off - 1 + t, 0] - batch["tp"]) ** 2)


def make_indexed_seq_step(c: SSMConfig, opt: AdamW):
    """The offline sequence-training step: ``step(params, opt_state,
    data, idx)``, whole UE traces gathered by index on the device (the
    sequence twin of :func:`make_indexed_step`)."""
    _check_differentiable(c)

    def step(params, opt_state, data, idx):
        dev = tree_leaves(params)[0].device
        idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int64)
        batch = {k: data[k].index_select(0, idx) for k in ("feats", "tp")}
        loss, grads = loss_and_grads(
            lambda p: ssm_seq_loss(c, p, batch), params)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def train_ssm(c: SSMConfig, data: dict, *, steps: int = 300,
              batch: int = 32, lr: float = 1e-3, seed: int = 0,
              log_every: int = 50, eval_data: dict | None = None,
              device="cuda"):
    """Offline teacher-forced trainer of the recurrent estimator:
    ``(params, history, metrics)`` as :func:`train_estimator`.

    ``data``: ``{"feats": (M, S, F), "tp": (M, T)}``, per-UE report
    traces (``estimator.ssm.episode_features``) and their last-T labels.
    The init from a ``torch.Generator(seed)``, the indices from
    ``np.random.default_rng(seed)``."""
    _check_differentiable(c)
    dev = resolve_device(device)
    params = init_ssm(c, torch.Generator().manual_seed(seed), device=dev)
    opt = AdamW(lr=lr, weight_decay=1e-4, clip_norm=1.0)
    opt_state = opt.init(params)
    step_fn = make_indexed_seq_step(c, opt)
    n = len(data["tp"])
    rng = np.random.default_rng(seed)
    data_dev = to_device(data, ("feats", "tp"), dev)
    history = []
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, batch))
        params, opt_state, loss = step_fn(params, opt_state, data_dev, idx)
        if i % log_every == 0 or i == steps - 1:
            history.append((i, float(loss)))
    metrics = None
    if eval_data is not None:
        pred = ssm_predict(c, params, eval_data, device=dev)
        metrics = r2_rmse(pred, eval_data["tp"])
    return params, history, metrics


def ssm_predict(c: SSMConfig, params: dict, data: dict,
                batch: int | None = 64, *, device="cuda") -> np.ndarray:
    """(M, T) predicted Mbps for every trace row of ``data`` (sequence
    mode, the labels' tail: the eval twin of :func:`predict`); with
    ``c.use_kernel`` through the ``ssd`` kernel."""
    outs = []
    n, t = len(data["tp"]), data["tp"].shape[1]
    off = data["feats"].shape[1] - t
    batch = max(n, 1) if batch is None else batch
    for i in range(0, n, batch):
        fc, _ = ssm_forward_seq(c, params, data["feats"][i:i + batch],
                                device=device)
        outs.append(fc[:, off - 1:off - 1 + t, 0].cpu().numpy())
    return np.concatenate(outs)


def fwd(e: EstimatorConfig, params: dict, kpms, iq, alloc, *,
        device="cuda") -> torch.Tensor:
    """One inference forward (the fleet engine's per-chunk call)."""
    return estimator_forward(e, params, kpms, iq, alloc, device=device)


def predict(e: EstimatorConfig, params: dict, data: dict,
            batch: int | None = 64, *, device="cuda") -> np.ndarray:
    """Predicted throughput (Mbps) for every row of ``data``.

    ``batch=None`` runs the whole input through one forward pass; an int
    chunks the input to bound peak memory."""
    outs = []
    n = len(data["tp"])
    batch = max(n, 1) if batch is None else batch
    for i in range(0, n, batch):
        outs.append(fwd(e, params, data["kpms"][i:i + batch],
                        data["iq"][i:i + batch], data["alloc"][i:i + batch],
                        device=device).cpu().numpy())
    return np.concatenate(outs)
