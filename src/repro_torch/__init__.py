"""PyTorch/CUDA port of the adaptive split-computing system.

The port of ``repro`` (JAX on a TPU) to PyTorch on an NVIDIA H100, one
slice at a time. It imports neither JAX nor the JAX package. The device
path is torch, with the TPU kernels of the main path rewritten as CUDA
kernels for Hopper (``repro_torch.kernels``); host-side planning stays
float64 numpy, as in the reference. Entry points take ``device=`` and
default to the card.
"""
from repro_torch import (channel, configs, core, estimator,  # noqa
                         kernels, models, sim, weights)
