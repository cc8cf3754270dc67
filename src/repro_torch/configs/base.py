"""Config system: every architecture is a ModelConfig; shapes are ShapeConfig.

The port's own copy of ``repro.configs.base`` (plain data, no JAX): the
same fields, derived properties, ``reduced()`` and registry, so a name gives
the same configuration in both packages.

Block patterns: a model is `pattern * (n_layers // len(pattern))` scanned
megablocks plus `n_layers % len(pattern)` unrolled remainder blocks. Block
kinds:
  attn        causal self-attention (window=0 -> full)  + MLP/MoE
  local       windowed self-attention + MLP
  cross       cross-attention to encoder/vision embeddings + MLP
  rec         RG-LRU recurrent block + MLP
  ssd         Mamba2 state-space-dual block (no MLP; block is the mixer)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclass(frozen=True)
class BlockSpec:
    """One position inside the repeated layer pattern."""

    kind: str = "attn"  # attn | local | cross | rec | ssd
    window: int = 0  # 0 = full attention; >0 sliding-window length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    pattern: Sequence[BlockSpec] = (BlockSpec(),)
    causal: bool = True  # False => encoder (bidirectional, no decode)
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # VLM cross-attention stub frontend
    vision_dim: int = 0
    vision_tokens: int = 0
    # audio stub frontend (precomputed frame embeddings)
    frame_input_dim: int = 0
    # RG-LRU
    lru_width: int = 0
    conv1d_width: int = 4
    # Mamba2 / SSD
    d_inner: int = 0
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # misc
    kv_dtype: str = "bf16"  # "int8": quantised KV cache (per-row scales)
    act: str = "silu"
    norm_eps: float = 1e-6
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived ----
    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def n_full_patterns(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> Sequence[BlockSpec]:
        return tuple(self.pattern)[: self.n_layers % len(self.pattern)]

    @property
    def max_window(self) -> int:
        """0 if any block uses full attention, else the largest window."""
        ws = [b.window for b in self.pattern if b.kind in ("attn", "local")]
        if not ws:
            return -1  # attention-free
        return 0 if any(w == 0 for w in ws) else max(ws)

    @property
    def sub_quadratic(self) -> bool:
        """False only for PURE full-attention stacks. Hybrids with windowed /
        recurrent / SSM mixing blocks (gemma3 5:1 local:global, mixtral SWA,
        recurrentgemma, mamba2) qualify for long_500k: their long-context
        state is dominated by the sub-quadratic blocks."""
        return any(
            b.window > 0 or b.kind in ("rec", "ssd") for b in self.pattern
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        c = self
        n = c.vocab * c.d_model  # embedding
        if not c.tie_embeddings:
            n += c.vocab * c.d_model
        for i in range(c.n_layers):
            b = c.pattern[i % len(c.pattern)]
            if b.kind in ("attn", "local", "cross"):
                qkv = c.d_model * (c.n_heads + 2 * c.kv_heads) * c.head_dim
                o = c.n_heads * c.head_dim * c.d_model
                n += qkv + o
                if c.num_experts:
                    n += c.num_experts * 3 * c.d_model * c.d_ff
                    n += c.d_model * c.num_experts  # router
                else:
                    n += 3 * c.d_model * c.d_ff
            elif b.kind == "rec":
                w = c.lru_width or c.d_model
                n += 2 * c.d_model * w + w * c.d_model + 2 * w  # proj + gates
                n += 3 * c.d_model * c.d_ff
            elif b.kind == "ssd":
                nh = c.d_inner // c.ssm_headdim
                n += c.d_model * (2 * c.d_inner + 2 * c.ssm_ngroups * c.ssm_state + nh)
                n += c.d_inner * c.d_model
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        c = self
        dense = dataclasses.replace(c, num_experts=0, top_k=0)
        full_moe_ff = 0
        active_ff = 0
        for i in range(c.n_layers):
            b = c.pattern[i % len(c.pattern)]
            if b.kind in ("attn", "local", "cross"):
                full_moe_ff += c.num_experts * 3 * c.d_model * c.d_ff
                active_ff += c.top_k * 3 * c.d_model * c.d_ff
        return dense.param_count() - (
            c.n_layers * 3 * c.d_model * c.d_ff
        ) + active_ff if False else (
            c.param_count() - full_moe_ff + active_ff
        )

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = tuple(self.pattern)
        small = dict(
            n_layers=len(pat) + 1 if len(pat) > 1 else 2,
            d_model=64,
            n_heads=4,
            kv_heads=2 if self.kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            num_experts=4 if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            vision_dim=32 if self.vision_dim else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            frame_input_dim=24 if self.frame_input_dim else 0,
            lru_width=64 if self.lru_width else 0,
            d_inner=128 if self.d_inner else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=32 if self.d_inner else 64,
            ssm_chunk=16,
            pattern=tuple(
                dataclasses.replace(b, window=min(b.window, 8) if b.window else 0)
                for b in pat
            ),
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


_REGISTRY: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # import for registration side effects
    from repro_torch.configs import (  # noqa: F401
        mixtral_8x22b,
        llama4_scout_17b_a16e,
        hubert_xlarge,
        llama_3_2_vision_90b,
        granite_8b,
        gemma3_27b,
        stablelm_1_6b,
        qwen2_72b,
        recurrentgemma_2b,
        mamba2_370m,
    )


def cell_status(arch: str, shape: str) -> str:
    """'ok' or 'skip:<reason>' for an (arch, shape) dry-run cell."""
    cfg = get_config(arch)
    _, _, kind = SHAPES[shape]
    if cfg.is_encoder and kind == "decode":
        return "skip:encoder-only (no decode step)"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return "skip:pure full-attention (long_500k needs sub-quadratic)"
    return "ok"
