"""Hand-written CUDA kernels for Hopper (sm_90a) on the port's main path.

Each kernel is a CUDA C++ source under ``csrc/``, built by ``_build`` with
nvcc into one shared library on first use and bound with ctypes. Beside
each wrapper sits its plain PyTorch version: the wrapper runs it for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel to it.

  featurize  fused KPM window extraction + normalisation
  lstm       fused fp32 LSTM-cell scan (the estimator's temporal branch)
"""
from repro_torch.kernels import featurize, lstm  # noqa: F401
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
