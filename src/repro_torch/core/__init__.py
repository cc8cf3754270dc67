# The paper's primary contribution: adaptive, constraint-filtered model
# partitioning (PSO lookup tables + UE energy model), driven by the AI
# throughput estimator (repro_torch/estimator) over simulated 5G channels
# (repro_torch/channel). Privacy, splitting and the boundary codec wait for
# the split-computing slice.
from repro_torch.core import (  # noqa: F401
    controller,
    energy,
    objective,
    profiles,
    pso,
)
