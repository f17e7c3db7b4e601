"""Detection-to-track associator: attentional GNN + Sinkhorn OT.

Counterpart of ``odam_tpu/models/associator.py``.  Padding semantics are the
same: padded detection rows (-1 features) take part in attention, padded
track slots are masked out of attention keys, and the history fuser's mean
runs over the full window, padded timesteps included.

The exact decode runs on the host (see :mod:`odam_torch.ops.lap`): one
blocking copy per call of the [B, T+1, N+1] log assignment and both masks,
counted in ``Associator.host_syncs``.

Feature layout per entity (79 columns): 0 time index | 1 class | 2:6
normalized bbox | 6:9 dims | 9:12 t_co | 12 sin azi | 13 cos azi | 14 score
| 15:79 shape code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops import lap, sinkhorn
from ..ops.attention import mha_core
from . import convert, position


@dataclass(frozen=True)
class AssociatorConfig:
    descriptor_dim: int = 256
    keypoint_encoder: Sequence[int] = (78, 256, 256)
    gnn_layers: Sequence[str] = ("self", "cross") * 4
    self_gnn_layers: Sequence[str] = ("self", "self")
    sinkhorn_iterations: int = 100
    num_heads: int = 4
    decode: str = "exact"  # "exact" (Hungarian on the host) | "greedy" (on device)

    @classmethod
    def from_cfg(cls, cfg: dict) -> "AssociatorConfig":
        """Build from the reference YAML schema (configs/detr_scan_net.yaml)."""
        return cls(
            descriptor_dim=int(cfg.get("descriptor_dim", 256)),
            keypoint_encoder=tuple(cfg.get("keypoint_encoder", (78, 256, 256))),
            gnn_layers=tuple(cfg.get("GNN_layers", ("self", "cross") * 4)),
            self_gnn_layers=tuple(cfg.get("self_GNN_layers", ("self", "self"))),
            sinkhorn_iterations=int(cfg.get("sinkhorn_iterations", 100)),
        )


class ChannelMLP(nn.Module):
    """Per-token MLP (Dense layers with ReLU between them)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}", nn.Linear(channels[i], channels[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class AttentionalPropagation(nn.Module):
    """message = MHA(x, source); returns MLP([x ; message])."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.merge = nn.Linear(d_model, d_model)
        self.mlp = ChannelMLP((2 * d_model, 2 * d_model, d_model))

    def forward(self, x, source, key_padding_mask=None):
        msg = mha_core(self.q_proj(x), self.k_proj(source), self.v_proj(source),
                       self.num_heads, key_padding_mask)
        return self.mlp(torch.cat([x, self.merge(msg)], dim=-1))


class AssociatorOutput(NamedTuple):
    log_assignment: torch.Tensor   # [B, T+1, N+1]
    scores: torch.Tensor           # [B, T, N] raw pre-Sinkhorn scores
    matches: torch.Tensor          # [B, N] int32 track per detection, -1 unmatched


class Associator(nn.Module):
    def __init__(self, config: AssociatorConfig = AssociatorConfig()):
        super().__init__()
        c = self.config = config
        D = c.descriptor_dim
        if c.decode not in ("exact", "greedy"):
            raise ValueError(f"unknown decode {c.decode!r}")
        self.encoder = ChannelMLP(tuple(c.keypoint_encoder))
        for i, _ in enumerate(c.self_gnn_layers):
            self.add_module(f"fuser_layer{i}", AttentionalPropagation(D, c.num_heads))
        for i, _ in enumerate(c.gnn_layers):
            self.add_module(f"gnn_layer{i}", AttentionalPropagation(D, c.num_heads))
        self.final_proj = nn.Linear(D, D)
        self.bin_score = nn.Parameter(torch.ones(()))
        self.host_syncs = 0

    def forward(self, tracks: torch.Tensor, track_mask: torch.Tensor,
                detections: torch.Tensor, det_mask: torch.Tensor,
                match_threshold: float = 0.1) -> AssociatorOutput:
        """
        Args:
            tracks: [B, T, W, 79] track histories (padded slots/timesteps = -1).
            track_mask: [B, T] bool validity of track slots.
            detections: [B, N, 79] this frame's detections (padded rows = -1).
            det_mask: [B, N] bool validity of detection slots.
        """
        c = self.config
        B, T, W, _ = tracks.shape
        D = c.descriptor_dim

        trk = self.encoder(tracks[..., 1:]) + position.timestep_encoding(tracks[..., 0], D)
        det = self.encoder(detections[..., 1:]) + position.timestep_encoding(
            detections[..., 0], D)

        # history fusion: self-attention over each track's window (B*T rows,
        # the plain path), then the mean over the full window
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

        t_feat = self.final_proj(t_feat)
        d_feat = self.final_proj(d_feat)
        scores = torch.einsum("btd,bnd->btn", t_feat, d_feat).float() / D ** 0.5
        Z = sinkhorn.log_optimal_transport(scores, self.bin_score.float(),
                                           iters=c.sinkhorn_iterations,
                                           row_mask=track_mask, col_mask=det_mask)
        matches = self._decode(Z, track_mask, det_mask, match_threshold)
        return AssociatorOutput(log_assignment=Z, scores=scores, matches=matches)

    def _decode(self, Z, track_mask, det_mask, threshold: float) -> torch.Tensor:
        if self.config.decode == "greedy":
            return torch.stack([
                lap.greedy_peel_match(torch.exp(Z[b, :-1, :-1]), threshold,
                                      track_mask[b], det_mask[b])
                for b in range(Z.shape[0])
            ])
        B, T1, N1 = Z.shape
        packed = torch.cat([Z.reshape(B, -1), track_mask.float(), det_mask.float()], dim=1)
        if packed.device.type != "cpu":
            packed = packed.cpu()          # the one blocking device-to-host read
            self.host_syncs += 1
        z = packed[:, :T1 * N1].reshape(B, T1, N1)
        tm = packed[:, T1 * N1:T1 * N1 + T1 - 1] > 0.5
        dm = packed[:, T1 * N1 + T1 - 1:] > 0.5
        matches = torch.stack([
            lap.match_by_score(torch.exp(z[b, :-1, :-1]), threshold, tm[b], dm[b])
            for b in range(B)
        ])
        if Z.device.type == "cpu":
            return matches
        return matches.pin_memory().to(Z.device, non_blocking=True)


def build_associator(config: AssociatorConfig = AssociatorConfig(), *, flax_params=None,
                     seed: int = 1, device: str | torch.device | None = None) -> Associator:
    """An Associator in eval mode on ``device`` (default: the card), with
    weights from ``flax_params`` or from the seeded init."""
    dev = resolve_device(device)
    model = Associator(config)
    if flax_params is not None:
        convert.load_flax_params(model, flax_params)
    else:
        convert.init_flax_like_(model, seed)
    return model.to(dev).eval()
