"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]: 24L d2048
32H (kv=32, MHA) ff5632 vocab 100352."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab=100352,
        pattern=(BlockSpec(kind="attn", window=0),),
        qkv_bias=True,
        rope_theta=10_000.0,
    )
)
