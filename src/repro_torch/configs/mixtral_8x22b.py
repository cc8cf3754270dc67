"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L d6144 48H GQA(kv=8) ff16384
vocab 32768, MoE 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        pattern=(BlockSpec(kind="attn", window=4096),),  # SWA all layers
        num_experts=8,
        top_k=2,
        rope_theta=1_000_000.0,
    )
)
