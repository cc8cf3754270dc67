"""Hand-written CUDA kernels for Hopper (sm_90a) on the port's main path.

Each kernel is a CUDA C++ source under ``csrc/``, built by ``_build`` with
nvcc into one shared library on first use and bound with ctypes. Beside
each wrapper sits its plain PyTorch version: the wrapper runs it for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel to it.

  featurize  fused KPM window extraction + normalisation
  lstm       fused LSTM-cell scans, fp32 and int8 (the estimator's
             temporal branch)
  quant      rowwise symmetric int8 quantization (qmax 127 or 7) of f32
             or bf16 rows
  qmm        int8 x int8 -> int32 rowwise-scaled matrix product
  segsum     batched segment sum / max (the PRB scheduler's normalizers,
             the per-cell load)
  ssd        Mamba-2 chunked SSD scan (the recurrent estimator's and the
             SSD LM's mixer): a fused route, and a chunk-parallel one on
             the tensor cores (bf16) or the CUDA cores
  pieces     the split of an f32 factor into three exact bf16 pieces
             (the plain version of what the bf16 tensor-core kernels do)
  dcor       pairwise Euclidean distances (distance correlation, the
             split-computing privacy metric)
  flash_attention
             online-softmax attention with causal and window masks (the
             LM's self-attention)
"""
from repro_torch.kernels import (dcor, featurize,  # noqa: F401
                                 flash_attention, lstm, qmm, quant, segsum,
                                 ssd)
from repro_torch.kernels._build import (LAUNCHES, ROUTES,  # noqa: F401
                                       reset_launches)
