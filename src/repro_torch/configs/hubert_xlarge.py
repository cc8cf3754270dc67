"""HuBERT X-Large [arXiv:2106.07447; unverified]: 48L d1280 16H ff5120
vocab 504 (masked-unit targets). Encoder-only; the CNN waveform frontend is a
STUB — input_specs() provides precomputed frame embeddings (d=512)."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab=504,
        pattern=(BlockSpec(kind="attn", window=0),),
        causal=False,  # bidirectional encoder
        frame_input_dim=512,
        act="gelu",
        rope_theta=10_000.0,
    )
)
