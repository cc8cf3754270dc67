"""Hand-written CUDA kernels for Hopper (sm_90a) on the port's main path.

Each kernel is a CUDA C++ source under ``csrc/``, built by ``_build`` with
nvcc into one shared library on first use and bound with ctypes. Beside
each wrapper sits its plain PyTorch version: the wrapper runs it for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel to it.

  featurize  fused KPM window extraction + normalisation
  lstm       fused LSTM-cell scans, fp32 and int8 (the estimator's
             temporal branch)
  quant      rowwise symmetric int8 quantization (qmax 127 or 7)
  qmm        int8 x int8 -> int32 rowwise-scaled matrix product
  segsum     batched segment sum / max (the PRB scheduler's normalizers,
             the per-cell load)
  ssd        Mamba-2 chunked SSD scan (the recurrent estimator's mixer)
  dcor       pairwise Euclidean distances (distance correlation, the
             split-computing privacy metric)
"""
from repro_torch.kernels import (dcor, featurize, lstm, qmm,  # noqa: F401
                                 quant, segsum, ssd)
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
