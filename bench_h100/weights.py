"""Seeded weights, made on the device in a few large calls.

The benchmark makes every weight itself and hands the same tensors to the
program (which copies them into its modules) and to the plain reference.
The draws follow Flax's default initialisers, as the port's own seeded
init does (``odam_torch/models/convert.py:init_flax_like_``), so activations
have the scale of the JAX package's seeded models: Dense and Conv kernels
normal with std ``fan_in ** -0.5`` (not truncated), biases 0, norm scales
1 and shifts 0, frozen batch norm the identity, ``query_embed`` standard
normal, ``bin_score`` 1.  One ``randn`` over every normal leaf, scaled by a
per-element factor made with one ``repeat_interleave``.
"""
from __future__ import annotations

import torch


def _kind(name: str, shape: tuple[int, ...]) -> str:
    """How a state-dict entry is drawn: "kernel" (fan-in normal), "normal",
    "ones" or "zeros"."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "query_embed":
        return "normal"
    if leaf in ("bin_score", "running_var"):
        return "ones"
    if leaf == "weight" and len(shape) >= 2:
        return "kernel"
    if leaf == "weight":
        return "ones"          # LayerNorm scale, frozen batch norm weight
    return "zeros"             # biases, norm shifts, running means


def seeded_state(shapes: dict[str, tuple[int, ...]], generator: torch.Generator,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for each named shape, drawn from
    ``generator`` (a generator on that device) in one call."""
    normal = [(k, s) for k, s in shapes.items() if _kind(k, s) in ("kernel", "normal")]
    counts = [int(torch.Size(s).numel()) for _, s in normal]
    std = [1.0 if _kind(k, s) == "normal" else float(torch.Size(s[1:]).numel()) ** -0.5
           for k, s in normal]
    flat = torch.randn(sum(counts), generator=generator, device=device)
    flat *= torch.repeat_interleave(torch.tensor(std, device=device),
                                    torch.tensor(counts, device=device))
    out = {}
    for (k, s), piece in zip(normal, torch.split(flat, counts)):
        out[k] = piece.view(s)
    for k, s in shapes.items():
        kind = _kind(k, s)
        if kind == "ones":
            out[k] = torch.ones(s, device=device)
        elif kind == "zeros":
            out[k] = torch.zeros(s, device=device)
    return {k: out[k] for k in shapes}


def module_shapes(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """The shapes of a module's state dict, in its order."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
