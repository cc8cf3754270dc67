"""Llama-3.2-Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision scaled;
unverified]: 100L d8192 64H GQA(kv=8) ff28672 vocab 128256. 80 self-attn
decoder layers with a cross-attention layer after every 4 (pattern SSSSX).
Vision tower is a STUB — input_specs() provides precomputed patch embeddings."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        pattern=(
            BlockSpec(kind="attn"),
            BlockSpec(kind="attn"),
            BlockSpec(kind="attn"),
            BlockSpec(kind="attn"),
            BlockSpec(kind="cross"),
        ),
        vision_dim=1280,
        vision_tokens=1601,  # 1 image tile of 1601 patches (stub frontend)
        rope_theta=500_000.0,
    )
)
