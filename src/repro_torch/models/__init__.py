"""The port's models: VGG16 (split computing) and the pattern-grouped LM."""
import torch

from repro_torch.models import blocks, lm, vgg  # noqa: F401
from repro_torch.models.template import init_from_template


def init_params(cfg, generator: torch.Generator, *, device="cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Random LM parameters in the reference's tree and init formulas,
    drawn from ``generator`` (on its device) and placed on ``device``;
    ``dtype=torch.bfloat16`` draws them in bf16, as served."""
    return init_from_template(lm.model_template(cfg), generator,
                              device=device, dtype=dtype)


def init_cache(cfg, batch: int, max_seq: int, *, device="cuda") -> dict:
    """An empty LM decode cache for ``batch`` sequences of up to
    ``max_seq`` positions, in the reference's tree and per-leaf dtypes (no
    dtype override: the f32 states stay f32)."""
    return lm.init_cache(cfg, batch, max_seq, device=device)
