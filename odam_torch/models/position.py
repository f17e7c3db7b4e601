"""Positional encodings for the DETR transformer and the associator.

Counterpart of ``odam_tpu/models/position.py``: the sine, learned and
timestep encodings.  Outputs are channels-last, as there.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def sine_position_encoding(mask: torch.Tensor, num_pos_feats: int = 128,
                           temperature: float = 10000.0,
                           dtype: torch.dtype = torch.float32,
                           offset: float = 0.0) -> torch.Tensor:
    """2D sine positional features from a padding mask; the cumulative
    coordinates, less ``offset`` (Deformable DETR's 0.5 puts each pixel at
    its centre), are normalized over the unpadded region to [0, 2 pi].  Made
    in float32, then cast to ``dtype``.

    Args:
        mask: [B, H, W] bool, True = padded pixel.

    Returns:
        [B, H, W, 2 * num_pos_feats] in ``dtype`` (y-features first).
    """
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    eps, scale = 1e-6, 2 * math.pi
    y_end, x_end = y_embed[:, -1:, :], x_embed[:, :, -1:]
    if offset:
        y_embed, x_embed = y_embed - offset, x_embed - offset
    y_embed = y_embed / (y_end + eps) * scale
    x_embed = x_embed / (x_end + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    # interleave sin/cos over channel pairs
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


class LearnedPositionEncoding(nn.Module):
    """Learned row and column embeddings: ``(B, H, W)`` -> [B, H, W, 2 F],
    the column's features first, then the row's.  Module names follow the
    Flax tree (``row_embed`` / ``col_embed``, each an ``embedding``)."""

    def __init__(self, num_pos_feats: int = 128, max_size: int = 50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.row_embed = nn.Embedding(max_size, num_pos_feats)
        self.col_embed = nn.Embedding(max_size, num_pos_feats)

    def forward(self, feature_shape: tuple[int, int, int]) -> torch.Tensor:
        B, H, W = feature_shape
        row, col = self.row_embed.weight[:H], self.col_embed.weight[:W]
        F = row.shape[-1]
        pos = torch.cat([col[None, :, :].expand(H, W, F), row[:, None, :].expand(H, W, F)], -1)
        return pos[None].expand(B, H, W, 2 * F).to(self.compute_dtype)


def timestep_encoding(position: torch.Tensor, d_model: int = 256) -> torch.Tensor:
    """Sinusoidal encoding of scalar time indices: [..., L] -> [..., L, d_model].

    Even channels sin, odd channels cos of position / 10000^(2i/d), in f32
    (the log constant is rounded to f32 first, as the JAX package does).
    """
    half = d_model // 2
    neg_log = float(-np.log(np.float32(10000.0)) / np.float32(d_model))
    div = torch.exp(2.0 * torch.arange(half, dtype=torch.float32, device=position.device)
                    * neg_log)
    arg = position[..., None] * div
    pe = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
    return pe.reshape(pe.shape[:-2] + (d_model,))
