"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) into one shared
library with a plain C interface, on first use, into
``build/repro_torch_kernels/`` at the root of the checkout. The library's
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the existing library. The sources compile
in parallel, one ``nvcc`` each, then link once.

Never add ``--use_fast_math``, ``-prec-div=false`` or ``-ftz=true`` here:
the featurize kernel is pinned bit-equal to the true-division reference.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C entry point -> argtypes; each returns cudaGetLastError() as an int
_SIGNATURES = {
    # (x, center, scale, out, n, length, k, window, stream)
    "repro_featurize_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (x, wx, wh, b, h_out, batch, steps, k, hidden, stream)
    "repro_lstm_scan_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (x, q, scale, n, d, qmax, f32(1 / qmax), stream)
    "repro_quantize_rows_s8": [_P, _P, _P, _I, _I, _I, _F, _P],
    # (xq, sx, wq, sw, out, part, m, n, k, splits, stream)
    "repro_qmm_s8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (x, wxq, wxs, whq, whs, b, h_out, batch, steps, k, hidden, stream)
    "repro_lstm_scan_q_s8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P],
    # (values, ids, out, t, n, c, op, stream)
    "repro_segsum_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (x, dt, a, bm, cm, y, state, batch, seqlen, nh, hd, groups, n, chunk,
    #  stream)
    "repro_ssd_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # (x, work, out, n, d, tile, chunk, splits, stream)
    "repro_pairwise_dists_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

LAUNCHES = {"featurize": 0, "lstm_scan": 0, "quantize": 0, "qmm": 0,
            "lstm_scan_q": 0, "segsum": 0, "ssd": 0, "pairwise_dists": 0}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc/ptxas output of the last build in this process


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def _build() -> Path:
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"librepro_torch_kernels_{tag}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    own = f"{tag}_{os.getpid()}"  # concurrent builders never share a file
    objs = [BUILD_DIR / f"{src.stem}_{own}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [(src.name, p.communicate()[0], p.returncode)
            for src, p in zip(sources, procs)]
    for name, out, rc in logs:
        if rc:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    tmp = BUILD_DIR / f".{lib.name}.{own}"
    link = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs), "-o",
                           str(tmp)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)  # atomic: a reader sees no half-written library
    build_log = "".join(f"== {name}\n{out}" for name, out, _ in logs)
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_launch(rc: int, name: str) -> None:
    """Raise unless the C entry point returned cudaSuccess (0)."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
