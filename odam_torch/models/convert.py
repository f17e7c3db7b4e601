"""Weight bridge from the JAX package's Flax parameter trees, and seeded init.

The inverse of ``odam_tpu/models/porting.py``.  The port's modules carry the
Flax tree's names, so a leaf converts by its path:

- Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW (the stem ``conv1/kernel``
  included);
- LayerNorm and GroupNorm ``scale`` -> ``weight``;
- Embed ``embedding`` -> Embedding ``weight``;
- everything else keeps its name and layout: biases, the four frozen-BN
  leaves, ``query_embed`` and ``bin_score``.

:func:`state_dict_to_flax` is the inverse: a module's state_dict as a Flax
tree of numpy arrays, which :func:`save_flax_npz` writes in the ``.npz``
layout that :func:`load_flax_npz` reads and that the JAX package's
``model.apply`` takes as ``{"params": tree}``.  :func:`flax_path` names a
state_dict key's Flax leaf.

Attention projections stay separate (q_proj, k_proj, v_proj, out_proj or
merge) and head-major: both packages split heads the same way, so no
permutation applies.  The caller passes the tree as nested dicts of numpy
arrays; JAX is never imported here.

:func:`init_flax_like_` gives a module its own seeded weights, drawn from a
``torch.Generator`` with Flax's default distributions, so full-width models
run with activations of the scale the JAX package's seeded models have.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def flax_to_state_dict(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves, optionally under ``"params"``) -> state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        name = path[-1]
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"kernel {'/'.join(path)} has rank {arr.ndim}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        key = ".".join(path[:-1] + (name,))
        if key in out:
            raise ValueError(f"two Flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))   # a writable copy
    return out


def load_flax_npz(path: str) -> dict:
    """A Flax parameter tree saved as ``.npz`` with ``/``-joined paths as keys
    (``tests/test_torch_checkpoints.py`` writes them from the committed
    orbax checkpoints) -> the nested dict of numpy arrays that
    ``build_detr`` / ``build_associator(flax_params=...)`` take."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as npz:
        for key in npz.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = npz[key]
    return tree


def flax_path(module: nn.Module, key: str) -> tuple[str, ...]:
    """The Flax path of ``module.state_dict()[key]``: the module path, then
    ``kernel`` for a Dense or Conv weight, ``scale`` for a LayerNorm or
    GroupNorm weight, ``embedding`` for an Embedding's, else the tensor's
    own name."""
    *parents, name = key.split(".")
    owner = module.get_submodule(".".join(parents))
    if name == "weight" and isinstance(owner, (nn.Linear, nn.Conv2d)):
        name = "kernel"
    elif name == "weight" and isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
        name = "scale"
    elif name == "weight" and isinstance(owner, nn.Embedding):
        name = "embedding"
    return tuple(parents) + (name,)


def state_dict_to_flax(module: nn.Module) -> dict:
    """The module's state_dict as a Flax tree of float32 numpy arrays (the
    inverse of :func:`flax_to_state_dict`)."""
    return tensors_to_flax(module, module.state_dict())


def tensors_to_flax(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> dict:
    """Tensors keyed and shaped as the module's state_dict entries (its
    weights, their gradients) -> a Flax tree of float32 numpy arrays:
    Linear ``weight`` [out, in] -> ``kernel`` [in, out], Conv2d OIHW -> HWIO."""
    tree: dict = {}
    for key, t in tensors.items():
        path = flax_path(module, key)
        arr = t.detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr.copy()             # C order, rank kept
    return tree


def save_flax_npz(path: str, tree: Mapping[str, Any]) -> None:
    """Write a Flax tree of numpy arrays as ``.npz`` with ``/``-joined paths
    as keys, the layout :func:`load_flax_npz` reads."""
    with open(path, "wb") as f:
        np.savez(f, **{"/".join(p): np.asarray(leaf) for p, leaf in _flatten(tree)})


def load_flax_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a Flax tree into ``module``; every leaf must map to exactly one
    tensor of the module and every tensor must come from exactly one leaf."""
    sd = flax_to_state_dict(tree)
    expected = module.state_dict()
    missing = sorted(set(expected) - set(sd))
    extra = sorted(set(sd) - set(expected))
    if missing or extra:
        raise KeyError(f"Flax tree does not match the module: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    for key, t in sd.items():
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: Flax {tuple(t.shape)} vs module "
                             f"{tuple(expected[key].shape)}")
    module.load_state_dict(sd, strict=True)
    return module


# Flax's truncated normal keeps [-2, 2] standard deviations and divides the
# std by this factor so the truncated draw keeps the asked-for variance.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    z = torch.erfinv(2 * u - 1) * math.sqrt(2)
    with torch.no_grad():
        w.copy_(z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


def init_flax_like_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded init with Flax's defaults: lecun-normal Dense/Conv kernels, zero
    biases, unit/zero norm affines, Embed's truncated normal of std
    features^-1/2, ``normal(1.0)`` for ``query_embed`` and
    1 for ``bin_score``.  Draws on the CPU, so a seed gives the same weights
    on every device."""
    gen = torch.Generator().manual_seed(seed)
    for name, mod in sorted(module.named_modules()):
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            _lecun_normal_(mod.weight, fan_in, gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            _lecun_normal_(mod.weight, mod.weight.shape[1], gen)
    with torch.no_grad():
        for name, p in module.named_parameters(recurse=False):
            if name == "query_embed":
                p.copy_(torch.randn(p.shape, generator=gen))
            elif name == "bin_score":
                p.fill_(1.0)
    return module
