"""Mamba2-370M [arXiv:2405.21060; unverified]: 48L d1024 attention-free,
SSD (state-space duality) mixer; d_inner 2048 (expand 2), headdim 64
(32 ssm heads), state 128, vocab 50280."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab=50280,
        pattern=(BlockSpec(kind="ssd"),),
        d_inner=2048,
        ssm_state=128,
        ssm_headdim=64,
        ssm_chunk=256,
        ssm_ngroups=1,
        tie_embeddings=True,
    )
)
