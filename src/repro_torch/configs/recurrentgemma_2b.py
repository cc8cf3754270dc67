"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf]: 26L d2560 10H
GQA(kv=1, MQA) ff7680 vocab 256000; pattern = 2 RG-LRU recurrent blocks per
1 local-attention (window 2048) block; lru_width 2560."""
from repro_torch.configs.base import BlockSpec, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        pattern=(
            BlockSpec(kind="rec"),
            BlockSpec(kind="rec"),
            BlockSpec(kind="local", window=2048),
        ),
        lru_width=2560,
        conv1d_width=4,
        act="gelu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        logit_softcap=30.0,
    )
)
