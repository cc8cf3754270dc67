"""The LM's serving steps, the counterparts of the reference's
``launch/steps.py::make_prefill_step`` and ``make_decode_step``: closures
over a configuration that a server calls with the parameters. The rest of
the reference's module (training steps, cells) is ROADMAP.md module queue
item 16."""
from __future__ import annotations

import torch

from repro_torch.models import lm


def make_prefill_step(cfg, max_seq: int, *, dtype=torch.bfloat16,
                      use_kernel=True, device="cuda"):
    """``prefill_step(params, batch) -> (last logits (B, 1, V), cache)``,
    the cache sized for ``max_seq`` positions (``lm.prefill``)."""
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, max_seq=max_seq, dtype=dtype,
                          use_kernel=use_kernel, device=device)

    return prefill_step


def make_decode_step(cfg, *, dtype=torch.bfloat16, device="cuda"):
    """``decode_step(params, cache, tokens, pos) -> (logits (B, 1, V),
    cache)``, the cache written in place (``lm.decode_step``)."""
    def decode_step(params, cache, tokens, pos):
        return lm.decode_step(cfg, params, cache, tokens, pos, dtype=dtype,
                              device=device)

    return decode_step
