"""Granite-8B-Code [arXiv:2405.04324; hf]: 36L d4096 32H GQA(kv=8) ff14336
vocab 49152, llama-style dense decoder."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=49152,
        pattern=(BlockSpec(kind="attn", window=0),),
        rope_theta=10_000_000.0,
    )
)
