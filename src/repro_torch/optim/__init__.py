"""repro_torch.optim — the reference's AdamW, written by hand."""
from repro_torch.optim.adamw import (AdamW, cosine_schedule,  # noqa: F401
                                     global_norm, tree_leaves)
