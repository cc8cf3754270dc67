"""Qwen2-72B [arXiv:2407.10671; hf]: 80L d8192 64H GQA(kv=8) ff29568
vocab 152064, QKV bias."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab=152064,
        pattern=(BlockSpec(kind="attn", window=0),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
)
