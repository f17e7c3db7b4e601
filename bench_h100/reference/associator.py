"""The plain reference associator: the attentional GNN, Sinkhorn and the exact
Hungarian decode, in float32.

Written after ``odam_torch/models/associator.py`` and
``odam_torch/models/position.py`` (their float32 plain path) under the same
state-dict names; the decode runs the host solver of :mod:`.lap`.  It
imports nothing of ``odam_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import lap, sinkhorn
from .detector import attention
from .layers import Dense


@dataclass(frozen=True)
class AssociatorConfig:
    descriptor_dim: int = 256
    keypoint_encoder: Sequence[int] = (78, 256, 256)
    gnn_layers: Sequence[str] = ("self", "cross") * 4
    self_gnn_layers: Sequence[str] = ("self", "self")
    sinkhorn_iterations: int = 100
    num_heads: int = 4

    @classmethod
    def from_model(cls, model: dict) -> "AssociatorConfig":
        return cls(descriptor_dim=int(model["descriptor_dim"]),
                   keypoint_encoder=tuple(model["keypoint_encoder"]),
                   gnn_layers=tuple(model["GNN_layers"]),
                   self_gnn_layers=tuple(model["self_GNN_layers"]),
                   sinkhorn_iterations=int(model["sinkhorn_iterations"]))


def timestep_encoding(position: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal encoding of time indices [..., L] -> [..., L, d_model]."""
    half = d_model // 2
    neg_log = float(-np.log(np.float32(10000.0)) / np.float32(d_model))
    div = torch.exp(2.0 * torch.arange(half, dtype=torch.float32, device=position.device)
                    * neg_log)
    arg = position[..., None] * div
    pe = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
    return pe.reshape(pe.shape[:-2] + (d_model,))


class ChannelMLP(nn.Module):
    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}", Dense(channels[i], channels[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class AttentionalPropagation(nn.Module):
    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj, self.k_proj = Dense(d, d), Dense(d, d)
        self.v_proj, self.merge = Dense(d, d), Dense(d, d)
        self.mlp = ChannelMLP((2 * d, 2 * d, d))

    def forward(self, x, source, key_padding_mask=None):
        msg = attention(self.q_proj(x), self.k_proj(source), self.v_proj(source),
                        self.num_heads, key_padding_mask)
        return self.mlp(torch.cat([x, self.merge(msg)], dim=-1))


class Output(NamedTuple):
    log_assignment: torch.Tensor   # [B, T+1, N+1]
    matches: torch.Tensor          # [B, N] int32 track per detection, -1 unmatched


class Associator(nn.Module):
    def __init__(self, c: AssociatorConfig):
        super().__init__()
        self.c = c
        D = c.descriptor_dim
        self.encoder = ChannelMLP(tuple(c.keypoint_encoder))
        for i, _ in enumerate(c.self_gnn_layers):
            self.add_module(f"fuser_layer{i}", AttentionalPropagation(D, c.num_heads))
        for i, _ in enumerate(c.gnn_layers):
            self.add_module(f"gnn_layer{i}", AttentionalPropagation(D, c.num_heads))
        self.final_proj = Dense(D, D)
        self.bin_score = nn.Parameter(torch.ones(()))

    def forward(self, tracks, track_mask, detections, det_mask, match_threshold: float
                ) -> Output:
        """tracks [B, T, W, 79], track_mask [B, T], detections [B, N, 79],
        det_mask [B, N]."""
        c = self.c
        B, T, W, _ = tracks.shape
        D = c.descriptor_dim
        trk = self.encoder(tracks[..., 1:]) + timestep_encoding(tracks[..., 0], D)
        det = self.encoder(detections[..., 1:]) + timestep_encoding(detections[..., 0], D)
        fused = trk.reshape(B * T, W, D)
        for i, _ in enumerate(c.self_gnn_layers):
            fused = fused + getattr(self, f"fuser_layer{i}")(fused, fused)
        fused = fused.mean(dim=1).reshape(B, T, D)
        trk_kpm = ~track_mask
        t_feat, d_feat = fused, det
        for i, kind in enumerate(c.gnn_layers):
            layer = getattr(self, f"gnn_layer{i}")
            if kind == "cross":
                t_src, t_kpm, d_src, d_kpm = d_feat, None, t_feat, trk_kpm
            else:
                t_src, t_kpm, d_src, d_kpm = t_feat, trk_kpm, d_feat, None
            t_feat, d_feat = (t_feat + layer(t_feat, t_src, t_kpm),
                              d_feat + layer(d_feat, d_src, d_kpm))
        t_feat, d_feat = self.final_proj(t_feat), self.final_proj(d_feat)
        scores = torch.einsum("btd,bnd->btn", t_feat, d_feat) / D ** 0.5
        Z = sinkhorn.log_optimal_transport(scores, self.bin_score.float(),
                                           iters=c.sinkhorn_iterations,
                                           row_mask=track_mask, col_mask=det_mask)
        matches = lap.match_by_score(torch.exp(Z[:, :-1, :-1]), match_threshold, track_mask,
                                     det_mask)
        return Output(log_assignment=Z, matches=matches)
