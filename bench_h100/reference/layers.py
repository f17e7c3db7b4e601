"""Plain float32 layers of the reference models, with an optional lower
operand precision for the control.

After ``odam_torch/models/layers.py`` at float32, where every cast is a
no-op: ``Dense`` and ``Conv`` are ``nn.Linear`` and ``nn.Conv2d`` under the
same state-dict names.  ``quant = "fp8"`` rounds both operands of each
product (the input and the weight) to float8 e4m3 with a per-tensor scale
and multiplies in float32: the reference computed one precision below the
bfloat16 that the configurations state, which the check must refuse.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0          # the largest finite float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, returned in float32."""
    amax = x.abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def _operands(layer, x: torch.Tensor):
    w, b = layer.weight, layer.bias
    if layer.quant == "fp8":
        return fp8_round(x), fp8_round(w), b
    if layer.quant is not None:
        raise ValueError(f"unknown operand precision {layer.quant!r}")
    return x.float(), w, b


class Dense(nn.Linear):
    quant: str | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_operands(self, x))


class Conv(nn.Conv2d):
    quant: str | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*_operands(self, x))


def set_quant(module: nn.Module, quant: str | None) -> nn.Module:
    """Every Dense and Conv of ``module`` at operand precision ``quant``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            m.quant = quant
    return module
