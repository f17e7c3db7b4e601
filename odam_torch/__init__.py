"""PyTorch / CUDA port of odam_tpu for one NVIDIA H100.

The package mirrors ``odam_tpu``'s module tree and imports neither JAX nor
anything of ``odam_tpu``.  Entry points (the model builders, the weight
loaders and :class:`odam_torch.runtime.processor.OdamPipeline`) run on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when a CUDA device is asked for (or implied) and none is present;
    an entry point never carries on on the CPU unless told to.
    """
    import torch   # here: a worker process that runs only NumPy code starts without it

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "odam_torch runs on a CUDA device unless device='cpu' is passed, "
            "and torch.cuda.is_available() is False")
    return dev
