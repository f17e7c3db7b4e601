"""Flax's mixed-precision semantics for the port's layers.

A Flax module built with ``dtype=jnp.bfloat16`` keeps its parameters in
float32 and casts them, with its input, to bf16 where it uses them:
``nn.Dense`` and ``nn.Conv`` multiply in bf16 and return bf16;
``nn.LayerNorm`` and ``nn.GroupNorm`` take their statistics in float32 and
return bf16.  ``torch.autocast`` differs (it runs normalizations and their
outputs in float32, and caches casts by its own rules), so these subclasses
of the torch layers carry a ``compute_dtype`` instead.  Their parameters and
state-dict names are the base classes', so weights convert and initialise as
before.  At float32 every cast is a no-op and the layers are the base ones.

:func:`dropout` is Flax's ``nn.Dropout`` with its mask drawn from a
``torch.Generator`` that the caller seeds.

Outside autograd, ``Dense`` and ``Conv`` cast their weight and bias once and
keep the copies until the parameters change (an in-place load bumps a
tensor's version, a move gives it new storage): the same operands as Flax's
cast at use, without two cast launches a layer on every call.  Under
autograd a layer whose weight or bias is trained casts at use; a frozen
layer keeps its cached copies, which an optimizer step, never writing a
frozen tensor, leaves valid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class _CastParams:
    """Weight and bias in ``compute_dtype``, cached outside autograd."""

    def _compute_params(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        dt, w, b = self.compute_dtype, self.weight, self.bias
        trained = w.requires_grad or (b is not None and b.requires_grad)
        if w.dtype == dt or (torch.is_grad_enabled() and trained):
            return w.to(dt), _cast(b, dt)
        key = (w.device, w.data_ptr(), w._version, None if b is None else b._version)
        if self.__dict__.get("_cast_key") != key:
            self._cast_key = key
            self._cast_params = (w.detach().to(dt), _cast(None if b is None else b.detach(), dt))
        return self._cast_params


class Dense(_CastParams, nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), *self._compute_params())


class Conv(_CastParams, nn.Conv2d):
    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.compute_dtype), *self._compute_params())


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or kept in float64 (a float64 model is a reference
    for gradients)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.LayerNorm):
    def __init__(self, d: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(at_least_f32(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    def __init__(self, groups: int, channels: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(groups, channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(at_least_f32(x), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: the input itself when not training or at rate 0,
    zeros at rate 1 (no draw), else ``where(keep, x / (1 - rate), 0)`` with
    ``keep`` drawn with probability 1 - rate from ``generator`` on x's device.
    The draws are not Flax's bits: only rates 0 and 1 match JAX exactly."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)
