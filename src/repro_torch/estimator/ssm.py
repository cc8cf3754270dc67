"""Recurrent SSM throughput estimator with K-period forecasts.

The O(1)-per-report alternative to the windowed estimator: each UE
carries a constant-size SSD recurrent state (the Mamba-2 recurrence of
``repro_torch.kernels.ssd``), one report updates it, and the readout emits
the current throughput estimate plus K-period-ahead forecasts by rolling
the recurrence forward in closed form.

Two execution modes share one parameter set:

  * sequence mode (``ssm_forward_seq``): a whole (B, S) trace through
    ``ssd_mixer``, the ``ssd`` kernel with ``SSMConfig(use_kernel=True)``
    (its plain version otherwise): the fleet path and state warm-up;
  * step mode (``ssm_step``): one report through ``ssd_step``, plain torch
    ops. A scan of steps reproduces the sequence pass to f32 tolerance.

Inputs are the 15 normalized KPMs plus the PRB allocation ratio and, with
``SSMConfig(include_iq=True)``, ``N_IQ_FEATS`` summary channels of the
period's IQ snapshot (``iq_features``). Parameters are a nested dict of
tensors with the reference's names and shapes (``ssm_template``), so a
reference tree carries over with ``repro_torch.weights``.

Forecast rollout, in closed form: holding the last input u, per head
``y_{t+j} = d^j y_t + (sum_{i<j} d^i) * dt * (C.B) * u`` with
``d = exp(dt*A)``. ``forecast_policy`` collapses the (K+1) forecasts to
the one throughput the controller consumes (``reduce_forecasts``, host
numpy); ``forecast_horizon=0`` gives the plain current estimate.

``seq_core`` and ``step_core`` are the differentiable passes on tensors
of one device; ``ssm_forward_seq`` and ``ssm_step`` run them for
inference (``torch.inference_mode``, full f32 on the card), the trainers
of ``estimator.train`` with autograd on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.channel import kpm as kpmmod
from repro_torch.channel.scenarios import WINDOW
from repro_torch.estimator.model import as_f32, check_params_device, full_f32
from repro_torch.kernels.ssd import ssd_mixer, ssd_step

F32 = torch.float32

FORECAST_POLICIES = ("last", "min", "discount")
N_IQ_FEATS = 6  # summary channels ``iq_features`` derives per snapshot


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Config of the recurrent estimator.

    ``forecast_horizon`` K adds K rolled-forward readouts per estimate;
    ``forecast_policy`` reduces them to one effective Mbps ("last" = the
    current estimate, "min" = the worst forecast period, "discount" =
    gamma-weighted mean). ``use_kernel`` routes sequence passes through
    the ``ssd`` kernel instead of its plain version."""

    n_kpms: int = 15
    n_heads: int = 4
    head_dim: int = 8
    n_groups: int = 1
    state_dim: int = 8  # N: SSD state columns per group
    hidden: int = 32  # readout MLP width
    forecast_horizon: int = 0  # K periods rolled forward
    forecast_policy: str = "last"
    forecast_discount: float = 0.8
    chunk: int = 64  # ssd_mixer chunk length for sequence passes
    use_kernel: bool = False
    include_iq: bool = False  # append per-period IQ summary channels

    def __post_init__(self):
        if self.n_heads % self.n_groups:
            raise ValueError(f"n_heads ({self.n_heads}) must divide into "
                             f"n_groups ({self.n_groups})")
        if self.forecast_policy not in FORECAST_POLICIES:
            raise ValueError(f"forecast_policy must be one of "
                             f"{FORECAST_POLICIES}: {self.forecast_policy!r}")
        if self.forecast_horizon < 0:
            raise ValueError(
                f"forecast_horizon must be >= 0: {self.forecast_horizon}")

    @property
    def n_feats(self) -> int:
        # 15 KPMs + the PRB allocation ratio (+ IQ summary channels)
        return self.n_kpms + 1 + (N_IQ_FEATS if self.include_iq else 0)

    @property
    def heads_per_group(self) -> int:
        return self.n_heads // self.n_groups

    def state_shape(self) -> tuple:
        """Per-UE recurrent state (the ssd carried-state layout)."""
        return (self.n_groups, self.heads_per_group, self.head_dim,
                self.state_dim)

    def state_bytes(self) -> int:
        """f32 bytes of recurrent state one UE costs the serving fleet."""
        return int(np.prod(self.state_shape())) * 4


def ssm_template(c: SSMConfig) -> dict:
    """{group: {name: (shape, init)}}: the reference's parameter leaves."""
    f, nh, hd = c.n_feats, c.n_heads, c.head_dim
    gn = c.n_groups * c.state_dim
    return {
        "in": {
            "wu": ((f, nh * hd), "fan_in"),
            "wdt": ((f, nh), "fan_in"),
            "bdt": ((nh,), "zeros"),
            "wb": ((f, gn), "fan_in"),
            "wc": ((f, gn), "fan_in"),
            "a_log": ((nh,), "zeros"),  # A = -e^a
        },
        # RMSNorm gain on the mixer output
        "norm": {"g": ((nh * hd,), "ones")},
        "head": {
            "w1": ((nh * hd + f, c.hidden), "fan_in"),
            "b1": ((c.hidden,), "zeros"),
            "w2": ((c.hidden, 1), "fan_in"),
            "b2": ((1,), "zeros"),
        },
    }


def init_ssm(c: SSMConfig, generator: torch.Generator, *,
             device="cuda") -> dict:
    """Random parameters with the template's init kinds: fan-in normal
    (std 1/sqrt(shape[-2]) for a matrix, 1/sqrt(shape[-1]) for a vector),
    zeros and ones. Drawn on the CPU from ``generator`` in template order,
    so a seed gives the same weights on every device, then moved to
    ``device``."""
    dev = resolve_device(device)
    params = {}
    for group, leaves in ssm_template(c).items():
        params[group] = {}
        for name, (shape, init) in leaves.items():
            if init == "zeros":
                t = torch.zeros(shape, dtype=F32)
            elif init == "ones":
                t = torch.ones(shape, dtype=F32)
            else:
                fan = shape[-2] if len(shape) >= 2 else shape[-1]
                t = torch.randn(shape, generator=generator, dtype=F32) \
                    / max(fan, 1) ** 0.5
            params[group][name] = t.to(dev)
    return params


def ssm_state_init(c: SSMConfig, batch_shape: tuple = (), *,
                   device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + c.state_shape(), dtype=F32,
                       device=resolve_device(device))


def iq_features(iq: np.ndarray) -> np.ndarray:
    """(..., 2, n_sc, 14) IQ spectrogram snapshots -> (..., N_IQ_FEATS)
    summary channels (host numpy): total log-power, narrowband peak,
    symbol burstiness, high/low subband contrast, tail power and
    occupancy."""
    x = np.asarray(iq, np.float32)
    p = x[..., 0, :, :] ** 2 + x[..., 1, :, :] ** 2  # (..., n_sc, 14)
    n_sc = p.shape[-2]
    psc = p.mean(-1)  # (..., n_sc) per-subcarrier power
    psym = p.mean(-2)  # (..., 14)  per-symbol power
    lo = psc[..., :n_sc // 2].mean(-1)
    hi = psc[..., n_sc // 2:].mean(-1)
    med = np.median(p, axis=(-2, -1))
    feats = np.stack([
        np.log1p(p.mean((-2, -1))),
        np.log1p(psc.max(-1)),
        np.log1p(psym).std(-1),
        np.log1p(hi) - np.log1p(lo),
        np.log1p(np.quantile(p, 0.95, axis=(-2, -1))),
        (p > 2.0 * med[..., None, None] + 1e-6).mean((-2, -1)),
    ], axis=-1)
    return feats.astype(np.float32)


def episode_features(kpms: np.ndarray, alloc_ratio: np.ndarray,
                     iq: np.ndarray | None = None) -> np.ndarray:
    """(N, S, F) f32 report-stream features from raw (N, S, 15) KPM
    reports + (N,) PRB ratios (host numpy): the fixed-affine KPM
    normalisation with the clipped alloc ratio as a 16th channel.

    ``iq`` (N, T, 2, n_sc, 14) appends ``N_IQ_FEATS`` summary channels:
    period ``t``'s snapshot lands on sequence index ``WINDOW - 1 + t``,
    the warm-up prefix carries zeros."""
    k = kpmmod.normalize_kpms(np.asarray(kpms)).astype(np.float32)
    n, s = k.shape[:2]
    a = np.broadcast_to(
        np.clip(np.asarray(alloc_ratio, np.float32), 0.0, 1.0)[:, None, None],
        (n, s, 1))
    cols = [k, a]
    if iq is not None:
        t = np.asarray(iq).shape[1]
        if t + WINDOW > s:
            raise ValueError(f"iq has {t} periods but the trace only "
                             f"fits {s - WINDOW}")
        iqf = np.zeros((n, s, N_IQ_FEATS), np.float32)
        iqf[:, WINDOW - 1:WINDOW - 1 + t] = iq_features(iq)
        cols.append(iqf)
    return np.concatenate(cols, axis=-1)


def _project(c: SSMConfig, params, feats):
    """feats (..., F) -> (u (..., nh, hd), dt (..., nh), Bm/Cm
    (..., G, N), A (nh,))."""
    p = params["in"]
    lead = tuple(feats.shape[:-1])
    u = (feats @ p["wu"]).reshape(lead + (c.n_heads, c.head_dim))
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus switches to the
    # identity above a threshold and rounds differently
    z = feats @ p["wdt"] + p["bdt"]
    dt = torch.logaddexp(z, torch.zeros_like(z))
    bm = (feats @ p["wb"]).reshape(lead + (c.n_groups, c.state_dim))
    cm = (feats @ p["wc"]).reshape(lead + (c.n_groups, c.state_dim))
    return u, dt, bm, cm, -torch.exp(p["a_log"])


def _readout(c: SSMConfig, params, y, feats):
    """(y (..., nh, hd), feats (..., F)) -> (...) Mbps."""
    p = params["head"]
    yf = y.reshape(tuple(y.shape[:-2]) + (c.n_heads * c.head_dim,))
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
    h = torch.cat([yf * params["norm"]["g"], feats], -1)
    h = F.relu(h @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"])[..., 0]


def _forecast_readout(c: SSMConfig, params, y, u, dt, bm, cm, feats, A):
    """(..., K+1) readouts: index 0 is the current estimate, index j the
    j-period-ahead forecast from the closed-form rollout (input held)."""
    outs = [_readout(c, params, y, feats)]
    if c.forecast_horizon:
        d = torch.exp(dt * A)  # (..., nh) per-head one-period decay
        cb = torch.sum(cm * bm, -1)  # (..., G): C.B
        cbh = torch.repeat_interleave(cb, c.heads_per_group, dim=-1)
        inj = (dt * cbh)[..., None] * u  # the held input's per-step push
        yj = y
        for _ in range(c.forecast_horizon):
            yj = d[..., None] * yj + inj
            outs.append(_readout(c, params, yj, feats))
    return torch.stack(outs, -1)


def _inputs(params, x, device):
    dev = resolve_device(device)
    check_params_device(params, dev)
    return as_f32(x, dev), dev


def seq_core(c: SSMConfig, params: dict, feats: torch.Tensor):
    """The sequence pass on an f32 (B, S, F) tensor of the parameters'
    device: ((B, S, K+1) forecasts, final state)."""
    u, dt, bm, cm, A = _project(c, params, feats)
    s = feats.shape[1]
    chunk = min(c.chunk, s)
    pad = -s % chunk
    if pad:
        def pz(a):  # zero rows after the trace, on axis 1
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        y, state = ssd_mixer(pz(u), pz(dt), A, pz(bm), pz(cm),
                             chunk=chunk, use_kernel=c.use_kernel)
        y = y[:, :s]
    else:
        y, state = ssd_mixer(u.contiguous(), dt.contiguous(), A,
                             bm.contiguous(), cm.contiguous(),
                             chunk=chunk, use_kernel=c.use_kernel)
    fc = _forecast_readout(c, params, y, u, dt, bm, cm, feats, A)
    return fc, state


def step_core(c: SSMConfig, params: dict, state: torch.Tensor,
              feats: torch.Tensor):
    """One report on f32 tensors of the parameters' device: (new state,
    (B, K+1) forecasts)."""
    u, dt, bm, cm, A = _project(c, params, feats)
    y, state = ssd_step(u, dt, A, bm, cm, state)
    fc = _forecast_readout(c, params, y, u, dt, bm, cm, feats, A)
    return state, fc


def ssm_forward_seq(c: SSMConfig, params: dict, feats, *, device="cuda"):
    """Sequence mode: feats (B, S, F) -> ((B, S, K+1) forecasts, final
    state (B,) + ``c.state_shape()``), on ``device``.

    The whole trace runs through one ``ssd_mixer`` call (chunk =
    ``min(c.chunk, S)``; the trace is padded to a chunk multiple with
    dt = 0 rows, which leave the state untouched, and the outputs are
    sliced back). Step ``s``'s forecasts see reports 0..s, so period ``t``
    of an episode trace reads index ``WINDOW + t - 1``."""
    feats, dev = _inputs(params, feats, device)
    with torch.inference_mode(), full_f32(dev):
        return seq_core(c, params, feats)


def ssm_step(c: SSMConfig, params: dict, state, feats, *, device="cuda"):
    """Step mode: one report per UE, O(1) in history length.

    ``state`` (B,) + ``c.state_shape()``; ``feats`` (B, F). Returns
    (new state, (B, K+1) forecasts), on ``device``."""
    feats, dev = _inputs(params, feats, device)
    state = as_f32(state, dev)
    with torch.inference_mode(), full_f32(dev):
        return step_core(c, params, state, feats)


def reduce_forecasts(c: SSMConfig, fc: np.ndarray) -> np.ndarray:
    """(..., K+1) forecasts -> (...) effective Mbps per the policy (host
    numpy, so every engine path collapses forecasts the same way). K = 0
    returns column 0 unchanged under every policy."""
    fc = np.asarray(fc)
    if c.forecast_horizon == 0 or c.forecast_policy == "last":
        return fc[..., 0]
    if c.forecast_policy == "min":
        return fc.min(axis=-1)
    w = c.forecast_discount ** np.arange(fc.shape[-1], dtype=np.float64)
    w /= w.sum()
    return fc @ w.astype(fc.dtype)


def ssm_warm_state(c: SSMConfig, params: dict, feats_prefix, *,
                   device="cuda") -> torch.Tensor:
    """Final recurrent state after consuming a (B, W, F) warm-up prefix:
    how a serving path seeds a UE's state from the reports that precede
    its first estimate."""
    return ssm_forward_seq(c, params, feats_prefix, device=device)[1]
