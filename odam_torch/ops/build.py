"""Builds the port's CUDA and C++ sources into shared libraries at first use.

Each source with a plain C interface becomes its own library,
``odam_torch/_build/lib<stem>_<hash>.so``, keyed by a hash of the source
and the compiler's flags, so a second call (or a second process) finds it
built.  The CUDA sources of ``odam_torch/csrc`` go through ``nvcc`` for
``sm_90a``; the host sampler of ``odam_torch/native`` through ``g++``.  The
wrappers load a library with ctypes; ``chip_smoke.py`` builds the CUDA ones
at once, one ``nvcc`` each.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use and need "
                       "the CUDA toolkit")


def build_library(stem: str, sources: tuple[Path, ...], info: dict,
                  compiler: str | None = None, flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    """Compile ``sources`` into ``lib<stem>_<hash>.so`` unless it exists
    (``compiler`` and ``flags``: nvcc and NVCC_FLAGS by default); ``info``
    gets the path, the seconds the compiler took and its report (ptxas')."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    out = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        info.update(path=str(out), seconds=None, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler or nvcc_path(), *flags, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed on {stem} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    info.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                ptxas=proc.stderr)
    return out
