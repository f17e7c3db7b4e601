"""Counterparts of the repository's ``examples/`` scripts.

Each module keeps its JAX original's functions and command line (positional
arguments, the same ``ODAM_*`` environment variables) and adds
``--device`` (``cuda`` by default; ``cpu`` to run without a card).  Run one
as ``python -m odam_torch.examples.<name>``.
"""


def resolve(device: str):
    """The device an example runs on (it raises for ``cuda`` without a card);
    on the card float32 stays float32: TF32 is turned off for matmuls and
    cuDNN's convolutions, as the training CLIs do."""
    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
