"""Gemma-3 27B [hf:google/gemma-3 family; unverified]: 62L d5376 32H
GQA(kv=16) ff21504 vocab 262144; 5 local (sliding-window 1024) layers per
1 global layer; 128k context."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab=262144,
        pattern=(
            BlockSpec(kind="local", window=1024),
            BlockSpec(kind="local", window=1024),
            BlockSpec(kind="local", window=1024),
            BlockSpec(kind="local", window=1024),
            BlockSpec(kind="local", window=1024),
            BlockSpec(kind="attn", window=0),  # global
        ),
        act="gelu",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        logit_softcap=30.0,
    )
)
