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
