# The paper's primary contribution: adaptive, constraint-filtered model
# partitioning (PSO lookup tables + dCor privacy + UE energy model), driven
# by the AI throughput estimator (repro_torch/estimator) over simulated 5G
# channels (repro_torch/channel), applied to VGG16 (core/splitting) with a
# quantising boundary codec (core/boundary). The LM half of splitting waits
# for the LM slice.
from repro_torch.core import (  # noqa: F401
    boundary,
    controller,
    energy,
    objective,
    privacy,
    profiles,
    pso,
    splitting,
)
