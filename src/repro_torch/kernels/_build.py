"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) into one shared
library with a plain C interface, on first use, into
``build/repro_torch_kernels/`` at the root of the checkout. The library's
name carries a hash of the sources, their ``csrc/*.cuh`` headers and the
flags, so an edited source builds anew and an unchanged one loads the
existing library. The sources compile
in parallel, one ``nvcc`` each (``build_log`` holds each one's output and
seconds), then link once.

Never add ``--use_fast_math``, ``-prec-div=false`` or ``-ftz=true`` here:
the featurize kernel is pinned bit-equal to the true-division reference.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels; ``ROUTES`` counts, for a wrapper with
more than one kernel, which it ran. ``max_clusters``, ``device_stream`` and
``scratch`` are what the wrappers ask of a card before a launch, cheaply.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

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
    "repro_lstm_scan_f32_cluster": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (x, q, scale, n, d, qmax, f32(1 / qmax), route, stream); x f32 or
    # bf16
    "repro_quantize_rows_s8": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    "repro_quantize_rows_bf16_s8": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    # (xq, sx, wq, sw, out, scratch, m, n, k, per_split, splits, cluster,
    #  stream)
    "repro_qmm_s8_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P],
    # (xq, sx, wq, sw, out, m, n, k, stream)
    "repro_qmm_s8_dp4a": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (x, wxq, wxs, whq, whs, b, h_out, batch, steps, k, hidden, stream)
    "repro_lstm_scan_q_s8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P],
    "repro_lstm_scan_q_s8_mma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P],
    # (values, ids, out, t, n, c, op, stream)
    "repro_segsum_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (x, dt, a, bm, cm, y, state, batch, seqlen, nh, hd, groups, n, chunk,
    #  stream)
    "repro_ssd_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # (x, dt, a, bm, cm, y, state, lcum, states, work, batch, seqlen, nh,
    #  hd, groups, n, chunk, kind, stream)
    "repro_ssd_chunked": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _I, _P],
    # (x, work, out, tickets, n, d, chunk, splits, cluster, stream) and
    # (x, out, n, d, stream)
    "repro_pairwise_dists_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_pairwise_dists_tiles_f32": [_P, _P, _I, _I, _P],
    # (cluster) and (cluster, two_tiles): clusters that run at once
    "repro_qmm_max_clusters": [_I],
    "repro_pairwise_dists_max_clusters": [_I, _I],
    # (q, k, v, o, bh, sq, sk, dh, causal, window, scale, stream); bf16 or
    # f32
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _F, _P],
    "repro_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _P],
}

LAUNCHES = {"featurize": 0, "lstm_scan": 0, "quantize": 0, "qmm": 0,
            "lstm_scan_q": 0, "segsum": 0, "ssd": 0, "pairwise_dists": 0,
            "flash_attention": 0}
# calls of each route of a wrapper that chooses one, beside its LAUNCHES
ROUTES = {"ssd": {"fused": 0, "chunked": 0, "chunked_wgmma": 0},
          "quantize": {"warp": 0, "warp_scalar": 0, "block": 0,
                       "cluster": 0, "two_pass": 0},
          "lstm_scan_q": {"mma": 0, "dp4a": 0},
          "lstm_scan": {"cluster": 0, "block": 0}}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc/ptxas output of the last build in this process
_scratch = {}  # (card, stream, dtype, zeroed) -> buffer, see scratch


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in ROUTES.values():
        for name in counts:
            counts[name] = 0


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
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
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

    def compile_one(src, obj):
        t0 = time.perf_counter()
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                            str(obj)], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        return src.name, r.stdout, r.returncode, time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(compile_one, sources, objs))
    for name, out, rc, _ in logs:
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
    build_log = "".join(f"== {name} ({sec:.1f} s)\n{out}"
                        for name, out, _, sec in logs)
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


@functools.lru_cache(maxsize=None)
def max_clusters(entry: str, index: int, *args: int) -> int:
    """How many clusters the card ``index`` runs at once for the C query
    ``entry`` (``repro_qmm_max_clusters``, ``repro_pairwise_dists_max_
    clusters``) at ``args`` (asked once)."""
    with torch.cuda.device(index):
        num = getattr(library(), entry)(*args)
    if num < 0:
        check_launch(-num, entry)
    return num


def device_stream(index: int):
    """(context, stream) for a launch on card ``index``: a context that
    makes the card current (nothing where it already is) and the card's
    current stream as the integer the C entry points take."""
    ctx = (contextlib.nullcontext() if torch.cuda.current_device() == index
           else torch.cuda.device(index))
    return ctx, torch._C._cuda_getCurrentRawStream(index)


def scratch(index: int, stream: int, n: int, dtype=torch.int32,
            zeroed: bool = True):
    """At least ``n`` elements of ``dtype`` on card ``index`` for the
    kernels of ``stream``, which runs them in order: one buffer a (card,
    stream, dtype, zeroed), reused by every launch.

    ``zeroed``: allocated with zeros, which the kernels that take it (qmm's
    split sums, both kernels' tickets) leave zero when they end: the block
    that reads a value last resets it, so a launch needs no memset."""
    key = (index, stream, dtype, zeroed)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < n:
        make = torch.zeros if zeroed else torch.empty
        buf = make(max(n, 4096), dtype=dtype,
                   device=torch.device("cuda", index))
        _scratch[key] = buf
    return buf
