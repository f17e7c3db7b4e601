"""The host C++ superquadric sampler, called through ctypes.

Counterpart of ``odam_tpu/native``, with its own copy of ``sq_sampler.cpp``
(equal-distance (eta, omega) sampling after Pilu & Fisher; the reference's
Cython/C++ sampler).  :func:`sample_sq_batch` is the host-side check of the
device sampler and a fast CPU path for tooling.  The library
(:data:`odam_torch.ops.kernels.NATIVE`) is compiled with ``g++`` at first
use into ``odam_torch/_build/``, keyed by a hash of the source, not next to
the source.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops.kernels import NATIVE


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
    scales = np.ascontiguousarray(scales, np.float32)
    epsilons = np.ascontiguousarray(epsilons, np.float32)
    if scales.ndim != 3 or scales.shape[-1] != 3 or epsilons.shape != scales.shape[:2] + (2,):
        raise ValueError(f"scales [B, M, 3] and epsilons [B, M, 2] expected, got "
                         f"{scales.shape} and {epsilons.shape}")
    B, M = scales.shape[:2]
    etas = np.empty((B, M, n_samples), np.float32)
    omegas = np.empty((B, M, n_samples), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    NATIVE.call("odam_sample_sq_batch", scales.ctypes.data_as(fp), epsilons.ctypes.data_as(fp),
                B, M, n_samples, grid, seed, 1 if deterministic else 0,
                etas.ctypes.data_as(fp), omegas.ctypes.data_as(fp))
    return etas, omegas
