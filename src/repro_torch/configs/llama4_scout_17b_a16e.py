"""Llama-4 Scout 17B-active 16E [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]: 48L d5120 40H GQA(kv=8) expert-ff 8192 vocab 202048,
MoE 16 experts top-1 (text backbone; early-fusion frontend stubbed)."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202048,
        pattern=(BlockSpec(kind="attn", window=0),),  # full attention
        num_experts=16,
        top_k=1,
        rope_theta=500_000.0,
    )
)
