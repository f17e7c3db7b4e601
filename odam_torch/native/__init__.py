"""The host C++ superquadric sampler, loaded with ctypes.

Counterpart of ``odam_tpu/native``, with its own copy of ``sq_sampler.cpp``
(equal-distance (eta, omega) sampling after Pilu & Fisher; the reference's
Cython/C++ sampler).  :func:`sample_sq_batch` is the host-side check of the
device sampler and a fast CPU path for tooling.  The library is compiled
with ``g++`` at first use into ``odam_torch/_build/``, keyed by a hash of
the source (:mod:`odam_torch.ops.build`), not next to the source.
"""
from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path

import numpy as np

from ..ops import build
from ..utils import metrics

SOURCES = (Path(__file__).with_name("sq_sampler.cpp"),)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_INFO: dict = {}
metrics.register_info("build", {"native": BUILD_INFO})
_lock = threading.Lock()
_lib = None


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the native sampler is built on first use")
            lib = ctypes.CDLL(str(build.build_library("odam_native", SOURCES, BUILD_INFO,
                                                      gxx, GXX_FLAGS)))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.odam_sample_sq_batch.restype = ctypes.c_int
            lib.odam_sample_sq_batch.argtypes = [fp, fp] + [ctypes.c_int] * 6 + [fp, fp]
            _lib = lib
    return _lib


def sample_sq_batch(scales: np.ndarray, epsilons: np.ndarray,
                    n_samples: int = 1000, grid: int = 201, seed: int = 0,
                    deterministic: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Sample (eta, omega) angle pairs for a batch of superquadrics.

    Args:
        scales: [B, M, 3] axis scales; epsilons: [B, M, 2] exponents.
        deterministic: stratified quantiles and a golden-ratio longitude
            lattice (the device sampler's construction); False: seeded
            mt19937 draws (the reference's randomized mode, seed 0 by
            default).

    Returns:
        (etas [B, M, N], omegas [B, M, N]) float32.
    """
    lib = load_library()
    scales = np.ascontiguousarray(scales, np.float32)
    epsilons = np.ascontiguousarray(epsilons, np.float32)
    if scales.ndim != 3 or scales.shape[-1] != 3 or epsilons.shape != scales.shape[:2] + (2,):
        raise ValueError(f"scales [B, M, 3] and epsilons [B, M, 2] expected, got "
                         f"{scales.shape} and {epsilons.shape}")
    B, M = scales.shape[:2]
    etas = np.empty((B, M, n_samples), np.float32)
    omegas = np.empty((B, M, n_samples), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.odam_sample_sq_batch(
        scales.ctypes.data_as(fp), epsilons.ctypes.data_as(fp), B, M, n_samples, grid, seed,
        1 if deterministic else 0, etas.ctypes.data_as(fp), omegas.ctypes.data_as(fp))
    if rc != 0:
        raise RuntimeError(f"odam_sample_sq_batch failed with code {rc}")
    return etas, omegas
