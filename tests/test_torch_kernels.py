"""The port's kernel seam (odam_torch/ops/kernels.py) on the CPU: the list of
its libraries and kernels, one plain call of each wrapper counted in the
one layout and zeroed by ``metrics.reset()``, each library's entry points
declared as its sources define them, and the native library built and bound
once by threads that ask for it at once (g++ builds it here)."""
from __future__ import annotations

import re
import threading

import numpy as np
import pytest
import torch

from odam_torch import native
from odam_torch.ops import cuda_attention, kernels, lap, msda, sinkhorn
from odam_torch.utils import metrics

KERNELS = {"fused_attention": "attention", "flash_attention": "attention",
           "lap_solve": "lap", "sinkhorn": "sinkhorn", "ms_deform_attn": "msda"}
EXTRAS = {"attention": {"LAUNCHES_BY_BATCH": {}, "ALIGN_COPIES": 0},
          "lap": {"ROUTE_LAUNCHES": {"registers": 0, "shared": 0}},
          "sinkhorn": {}, "msda": {"SAMPLES": 0}}


def _plain_call(name: str) -> None:
    """One CPU call of ``name``'s wrapper, in float32."""
    g = torch.Generator().manual_seed(0)
    if name in ("fused_attention", "flash_attention"):
        q, k = torch.randn(1, 5, 2, 16, generator=g), torch.randn(1, 9, 2, 16, generator=g)
        getattr(cuda_attention, name)(q, k, k)
    elif name == "lap_solve":
        lap.solve(torch.rand(2, 3, 4, generator=g))
    elif name == "sinkhorn":
        sinkhorn.log_optimal_transport(torch.randn(2, 3, 4, generator=g), torch.tensor(1.0),
                                       iters=3)
    else:
        shapes, starts = ((4, 4), (2, 2)), (0, 16)
        value = torch.randn(1, 20, 2, 32, generator=g)
        loc = torch.rand(1, 3, 2, 2, 4, 2, generator=g)
        msda.ms_deform_attn(value, shapes, starts, loc, torch.rand(1, 3, 2, 2, 4, generator=g))


def test_the_seam_lists_every_kernel_in_its_library():
    assert {name: k.library.name for name, k in kernels.KERNELS.items()} == KERNELS
    assert set(kernels.LIBRARIES) == {"attention", "lap", "sinkhorn", "msda", "native"}
    assert {name: set(g) for name, g in kernels.GROUPS.items()} == {
        group: {"LAUNCHES", "PLAIN_CALLS", "LAUNCHES_BY_DTYPE", "PLAIN_CALLS_BY_DTYPE",
                *extras} for group, extras in EXTRAS.items()}


@pytest.mark.parametrize("name", list(KERNELS))
def test_a_plain_call_is_counted_in_the_one_layout_and_reset_zeroes_it(name):
    """A CPU call of the wrapper is one plain call of its kernel in float32
    and no launch; ``metrics.reset()`` sets every count of the kernel back as
    declared, its group's extras included (split ones emptied)."""
    group = KERNELS[name]
    kernels.zero_counts()
    with torch.no_grad():
        _plain_call(name)
    assert kernels.counts("PLAIN_CALLS") == {k: int(k == name) for k in KERNELS}
    assert kernels.counts("LAUNCHES") == dict.fromkeys(KERNELS, 0)
    assert kernels.counts("PLAIN_CALLS_BY_DTYPE")[name]["float32"] == 1
    assert metrics.snapshot()["counters"][group]["PLAIN_CALLS"][name] == 1
    kernel = kernels.KERNELS[name]
    for extra, start in EXTRAS[group].items():
        kernel.add(extra, 3, at=next(iter(start), 16) if isinstance(start, dict) else None)
        assert kernels.counts(extra)[name] != start, extra
    metrics.reset()
    for key, counts in kernels.GROUPS[group].items():
        start = EXTRAS[group].get(key, dict.fromkeys(kernel.dtypes, 0) if "DTYPE" in key else 0)
        assert counts[name] == start, key


@pytest.mark.parametrize("library", ["attention", "lap", "sinkhorn", "msda", "native"])
def test_each_entry_point_is_declared_as_its_source_defines_it(library):
    """Every declared entry is an ``int`` function of the library's sources
    with one parameter per ctypes argument type; a CUDA kernel's takes the
    stream last, where ``Library.call`` passes it, and the host sampler's
    takes none."""
    lib = kernels.LIBRARIES[library]
    text = "".join(src.read_text() for src in lib.sources)
    for entry, argtypes in lib.entries.items():
        m = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)", text)
        assert m, entry
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), entry
        assert (params[-1] == "void* stream") == (lib.compiler == "nvcc"), entry


def test_threads_asking_for_the_native_library_at_once_build_and_bind_it_once(
        tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    lib = kernels.Library("native", kernels.NATIVE.sources, kernels.NATIVE.entries,
                          compiler="g++", flags=kernels.GXX_FLAGS, listed=False)
    builds, real = [], kernels.Library.build
    monkeypatch.setattr(kernels.Library, "build", lambda self: builds.append(1) or real(self))
    start, got = threading.Barrier(8), []

    def ask():
        start.wait()
        got.append(lib.load())

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 8 and all(fns is got[0] for fns in got)
    assert lib.info["cached"] is False and list(tmp_path.glob("libodam_native_*.so"))
    assert kernels.LIBRARIES["native"] is kernels.NATIVE is not lib
    scales = np.full((1, 2, 3), 0.5, np.float32)
    eps = np.full((1, 2, 2), 1.0, np.float32)
    monkeypatch.setattr(native, "NATIVE", lib)
    etas, omegas = native.sample_sq_batch(scales, eps, 50)
    assert etas.shape == omegas.shape == (1, 2, 50) and np.isfinite(etas).all()
