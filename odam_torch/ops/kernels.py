"""The port's one seam to its hand-written libraries: each is declared here,
and built, bound, launched and counted here.

A :class:`Library` is one shared library with a plain C interface: its
sources, its compiler and flags, and its entry points with their ctypes
argument types (each returns an int, 0 on success).  At first use it is
compiled into ``odam_torch/_build/lib<stem>_<hash>.so``, keyed by a hash of
the sources and the flags, so a second call (or a second process) finds it
built: the CUDA sources of ``odam_torch/csrc`` through ``nvcc`` for
``sm_90a``, the host sampler of ``odam_torch/native`` through ``g++``.  It
is built and bound once, under its own lock, and the build is recorded
under ``build`` in :func:`odam_torch.utils.metrics.snapshot`.
:meth:`Library.call` runs an entry point (a CUDA library's on a tensor's
device and its current stream) and raises, naming the entry, on a nonzero
code that the caller did not ask back.

A :class:`Kernel` is one kernel of a library as its wrapper counts it.  The
kernels of a wrapper make one counter group of ``snapshot()["counters"]``
(``attention``, ``lap``, ``sinkhorn``, ``msda``), all in one layout:
``LAUNCHES[kernel]``, ``PLAIN_CALLS[kernel]`` (the calls for which the
wrapper ran its plain version: CPU tensors, or no ``use_kernels``),
``LAUNCHES_BY_DTYPE[kernel][dtype]`` and ``PLAIN_CALLS_BY_DTYPE[kernel][dtype]``
(by the dtype the call computes in), and the group's extras, one a kernel.
:func:`odam_torch.utils.metrics.reset` and :func:`zero_counts` set them back
as declared.

``LIBRARIES`` and ``KERNELS`` list them all: whatever builds, zeroes or reads
the kernels takes them from here.  A new kernel is one :class:`Library` (or
an entry of one) and one :func:`_declare` below, and its wrapper calls
:meth:`Kernel.launch` and :meth:`Kernel.plain`.
"""
from __future__ import annotations

import copy
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..utils import metrics

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
DTYPES = ("float32", "bfloat16")        # the instantiations of a kernel, by default

LIBRARIES: dict[str, "Library"] = {}
KERNELS: dict[str, "Kernel"] = {}
GROUPS: dict[str, dict] = {}            # each group's counters, as snapshot() shows them
_zeroes: list = []


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use and need "
                       "the CUDA toolkit")


class Library:
    """One shared library of the port (module docstring).  ``entries`` maps
    each entry point to its ctypes argument types; a CUDA kernel's entry
    takes the stream last, which :meth:`call` passes."""

    def __init__(self, name: str, sources: tuple[Path, ...], entries: dict[str, list],
                 compiler: str = "nvcc", flags: tuple[str, ...] = NVCC_FLAGS,
                 stem: str | None = None, listed: bool = True):
        self.name, self.sources, self.entries = name, sources, entries
        self.compiler, self.flags, self.stem = compiler, flags, stem or f"odam_{name}"
        self.info: dict = {}      # the build: path, seconds, cached, the compiler's report
        self._fns: dict | None = None
        self._lock = threading.Lock()
        if listed:
            LIBRARIES[name] = self
            metrics.register_info("build", {name: self.info})

    def variant(self, stem: str, flags: tuple[str, ...], entries: dict[str, list]) -> "Library":
        """The same sources built apart with ``flags`` added and ``entries``
        besides (a dev build, such as the LAP kernel's clocked one): not in
        the list, and not recorded."""
        return Library(self.name, self.sources, {**self.entries, **entries}, self.compiler,
                       self.flags + flags, stem, listed=False)

    def build(self) -> Path:
        """Compile the sources into ``lib<stem>_<hash>.so`` unless it exists."""
        digest = hashlib.sha256()
        for src in self.sources:
            digest.update(src.read_bytes())
        digest.update(" ".join(self.flags).encode())
        out = BUILD_DIR / f"lib{self.stem}_{digest.hexdigest()[:16]}.so"
        if out.exists():
            self.info.update(path=str(out), seconds=None, cached=True)
            return out
        compiler = nvcc_path() if self.compiler == "nvcc" else shutil.which(self.compiler)
        if compiler is None:
            raise RuntimeError(f"{self.compiler} not found: the {self.name} library is built "
                               "on first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *self.flags, "-o", tmp, *map(str, self.sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{cmd[0]} failed on {self.stem} ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        self.info.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                         ptxas=proc.stderr)
        return out

    def load(self) -> dict:
        """The entry points by name, the library built and bound at the
        first call (once, whatever threads ask at once)."""
        if self._fns is None:
            with self._lock:
                if self._fns is None:
                    lib = ctypes.CDLL(str(self.build()))
                    fns = {}
                    for entry, argtypes in self.entries.items():
                        fns[entry] = getattr(lib, entry)
                        fns[entry].argtypes, fns[entry].restype = argtypes, ctypes.c_int
                    self._fns = fns
        return self._fns

    def call(self, entry: str, *args, device: torch.device | None = None,
             returns: tuple[int, ...] = ()) -> int:
        """Run ``entry`` on ``args``: on the host, or with a ``device`` on
        that device's current stream (passed last), entering the device only
        when it is not the current one.  Returns its code: 0, or one of ``returns``; any other
        code raises."""
        fn = self.load()[entry]
        if device is None:
            code = fn(*args)
        elif device.index == torch.cuda.current_device():
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code and code not in returns:
            raise RuntimeError(f"{entry} failed: {'code' if device is None else 'cudaError'} "
                               f"{code}")
        return code


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class Kernel:
    """One kernel of a library, counted under its name in its group; its
    entry point is ``odam_<name>`` unless a launch names another."""

    def __init__(self, name: str, library: Library, group: str, dtypes: tuple[str, ...]):
        self.name, self.library, self.group, self.dtypes = name, library, group, dtypes
        self.entry = f"odam_{name}"

    def add(self, key: str, n: int = 1, at=None) -> None:
        """Count ``n`` in this kernel's ``key``; ``at`` is the entry of a
        split count (a dtype, a batch, a route)."""
        counts = GROUPS[self.group][key]
        if at is None:
            counts[self.name] += n
        else:
            split = counts[self.name]
            split[at] = split.get(at, 0) + n

    def launch(self, device: torch.device, dtype: torch.dtype, *args, entry: str | None = None,
               returns: tuple[int, ...] = ()) -> int:
        """:meth:`Library.call` on ``device``, counted as a launch of
        ``dtype`` when it returns 0."""
        code = self.library.call(entry or self.entry, *args, device=device, returns=returns)
        if code == 0:
            self.add("LAUNCHES")
            self.add("LAUNCHES_BY_DTYPE", at=_dtype_name(dtype))
        return code

    def plain(self, dtype: torch.dtype) -> None:
        """Count one call of the plain version in ``dtype``."""
        self.add("PLAIN_CALLS")
        self.add("PLAIN_CALLS_BY_DTYPE", at=_dtype_name(dtype))


def _declare(group: str, library: Library, names: tuple[str, ...],
             dtypes: tuple[str, ...] = DTYPES, **extras) -> None:
    """Declare the kernels ``names`` of ``library`` and register their
    counters as ``group``: the layout's four, and ``extras``, each one a
    kernel that starts from the value given (0, or a dict)."""
    start = {"LAUNCHES": 0, "PLAIN_CALLS": 0, "LAUNCHES_BY_DTYPE": dict.fromkeys(dtypes, 0),
             "PLAIN_CALLS_BY_DTYPE": dict.fromkeys(dtypes, 0), **extras}
    counts = GROUPS[group] = {key: {name: copy.copy(v) for name in names}
                              for key, v in start.items()}

    def zero() -> None:
        for key, v in start.items():
            for name in names:
                if isinstance(v, dict):
                    counts[key][name].clear()
                    counts[key][name].update(v)
                else:
                    counts[key][name] = v

    metrics.register_counters(group, counts, zero)
    _zeroes.append(zero)
    for name in names:
        KERNELS[name] = Kernel(name, library, group, dtypes)


def counts(key: str) -> dict:
    """Every kernel's ``key`` as it stands (a copy), by kernel; a kernel
    whose group has no such extra is left out."""
    return {name: copy.deepcopy(GROUPS[k.group][key][name]) for name, k in KERNELS.items()
            if key in GROUPS[k.group]}


def zero_counts() -> None:
    """Set every kernel's counts back as declared, and nothing else."""
    for zero in _zeroes:
        zero()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
_CSRC = PKG / "csrc"
# q, k, v, mask, out; dtype, B, H, Lq, Lk, dh, the strides of q, k, v, out and mask; stream
_ATTENTION_ARGS = [_P] * 5 + [_I] * 19 + [_P]
ATTENTION = Library("attention", (_CSRC / "attention.cu",),
                    {"odam_fused_attention": _ATTENTION_ARGS,
                     "odam_flash_attention": _ATTENTION_ARGS})
# cost, col4row; S, R, C; a problem's stride; (registers route: K, staged rows;) stream
LAP = Library("lap", (_CSRC / "lap.cu",), {
    "odam_lap_solve": [_P] * 2 + [_I] * 3 + [ctypes.c_longlong, _P],
    "odam_lap_solve_regs": [_P] * 2 + [_I] * 3 + [ctypes.c_longlong] + [_I] * 2 + [_P]})
# scores, row mask, column mask, alpha, out; S, M, N, iterations; stream
SINKHORN = Library("sinkhorn", (_CSRC / "sinkhorn.cu",),
                   {"odam_sinkhorn": [_P] * 5 + [_I] * 4 + [_P]})
# value, locations, weights, out; dtype, B, S, Lq, H, dh, L, P; the levels' h, w and
# starts; stream
MSDA = Library("msda", (_CSRC / "msda.cu",),
               {"odam_ms_deform_attn": [_P] * 4 + [_I] * 8 + [ctypes.POINTER(_I)] * 3 + [_P]})
# scales, epsilons; B, M, N, grid, seed, mode; etas, omegas
NATIVE = Library("native", (PKG / "native" / "sq_sampler.cpp",),
                 {"odam_sample_sq_batch": [_F] * 2 + [_I] * 6 + [_F] * 2},
                 compiler="g++", flags=GXX_FLAGS)

_declare("attention", ATTENTION, ("fused_attention", "flash_attention"),
         LAUNCHES_BY_BATCH={}, ALIGN_COPIES=0)
_declare("lap", LAP, ("lap_solve",), ("float32",), ROUTE_LAUNCHES={"registers": 0, "shared": 0})
_declare("sinkhorn", SINKHORN, ("sinkhorn",), ("float32",))
_declare("msda", MSDA, ("ms_deform_attn",), SAMPLES=0)
