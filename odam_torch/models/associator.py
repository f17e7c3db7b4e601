"""Detection-to-track associator: attentional GNN + Sinkhorn OT.

Counterpart of ``odam_tpu/models/associator.py``.  Padding semantics are the
same: padded detection rows (-1 features) take part in attention, padded
track slots are masked out of attention keys, and the history fuser's mean
runs over the full window, padded timesteps included.

The exact decode solves all B problems of a call in one launch of the LAP
kernel (:func:`odam_torch.ops.lap.match_by_score`), on the device and with
no host read.  Training needs no decode: :meth:`Associator.assignment`
stops at the log assignment, and :func:`association_nll` is the loss.  ``use_kernels`` (JAX's
``use_pallas``) sends the GNN's attention to the CUDA kernels; training
turns it off.  ``lanes`` in :meth:`Associator.forward` and
:meth:`Associator.assignment` is the number of scenes stacked on the batch
axis (the scene-parallel step), which the attention routes on: the GNN's
calls at B = lanes take the kernels, the history fuser's at B = lanes x T
the plain path, as each lane's calls do in JAX.

``AssociatorConfig.dtype`` is the compute dtype of the encoder, the GNN and
the final projection, with Flax's semantics (:mod:`.layers`); the time
encodings are made in float32 and cast, and the scores, the bin score,
Sinkhorn and the decode run in float32, as in JAX.

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
from ..utils import metrics
from . import convert, position
from .layers import Dense


@dataclass(frozen=True)
class AssociatorConfig:
    descriptor_dim: int = 256
    keypoint_encoder: Sequence[int] = (78, 256, 256)
    gnn_layers: Sequence[str] = ("self", "cross") * 4
    self_gnn_layers: Sequence[str] = ("self", "self")
    sinkhorn_iterations: int = 100
    num_heads: int = 4
    decode: str = "exact"  # "exact" (Hungarian, the LAP kernel) | "greedy"
    dtype: torch.dtype = torch.float32   # compute dtype: float32 or bfloat16
    use_kernels: bool = True       # the attention kernels (JAX: use_pallas)

    @classmethod
    def from_cfg(cls, cfg: dict, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True) -> "AssociatorConfig":
        """Build from the reference YAML schema (configs/detr_scan_net.yaml)."""
        return cls(
            descriptor_dim=int(cfg.get("descriptor_dim", 256)),
            keypoint_encoder=tuple(cfg.get("keypoint_encoder", (78, 256, 256))),
            gnn_layers=tuple(cfg.get("GNN_layers", ("self", "cross") * 4)),
            self_gnn_layers=tuple(cfg.get("self_GNN_layers", ("self", "self"))),
            sinkhorn_iterations=int(cfg.get("sinkhorn_iterations", 100)),
            dtype=dtype,
            use_kernels=use_kernels,
        )


class ChannelMLP(nn.Module):
    """Per-token MLP (Dense layers with ReLU between them)."""

    def __init__(self, channels: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(channels) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}", Dense(channels[i], channels[i + 1], dtype=dtype))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class AttentionalPropagation(nn.Module):
    """message = MHA(x, source); returns MLP([x ; message])."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernels = use_kernels
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.merge = Dense(d_model, d_model, dtype=dtype)
        self.mlp = ChannelMLP((2 * d_model, 2 * d_model, d_model), dtype)

    def forward(self, x, source, key_padding_mask=None, lanes: int = 1):
        msg = mha_core(self.q_proj(x), self.k_proj(source), self.v_proj(source),
                       self.num_heads, key_padding_mask, self.use_kernels, lanes)
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
        if c.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {c.dtype} is not float32 or bfloat16")
        self.encoder = ChannelMLP(tuple(c.keypoint_encoder), c.dtype)
        for i, _ in enumerate(c.self_gnn_layers):
            self.add_module(f"fuser_layer{i}",
                            AttentionalPropagation(D, c.num_heads, c.dtype, c.use_kernels))
        for i, _ in enumerate(c.gnn_layers):
            self.add_module(f"gnn_layer{i}",
                            AttentionalPropagation(D, c.num_heads, c.dtype, c.use_kernels))
        self.final_proj = Dense(D, D, dtype=c.dtype)
        self.bin_score = nn.Parameter(torch.ones(()))

    def forward(self, tracks: torch.Tensor, track_mask: torch.Tensor,
                detections: torch.Tensor, det_mask: torch.Tensor,
                match_threshold: float = 0.1, lanes: int = 1) -> AssociatorOutput:
        """
        Args:
            tracks: [B, T, W, 79] track histories (padded slots/timesteps = -1).
            track_mask: [B, T] bool validity of track slots.
            detections: [B, N, 79] this frame's detections (padded rows = -1).
            det_mask: [B, N] bool validity of detection slots.
            lanes: scenes stacked on the batch axis, which the attention routes on.
        """
        with metrics.span("odam.gnn"):
            scores = self.match_scores(tracks, track_mask, detections, det_mask, lanes)
        with metrics.span("odam.sinkhorn"):
            Z = self._transport(scores, track_mask, det_mask)
        with metrics.span("odam.lap"):
            matches = self._decode(Z, track_mask, det_mask, match_threshold)
        return AssociatorOutput(log_assignment=Z, scores=scores, matches=matches)

    def assignment(self, tracks: torch.Tensor, track_mask: torch.Tensor,
                   detections: torch.Tensor, det_mask: torch.Tensor, lanes: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The forward without the decode: (log assignment [B, T+1, N+1], raw
        scores [B, T, N]), with no host copy."""
        scores = self.match_scores(tracks, track_mask, detections, det_mask, lanes)
        return self._transport(scores, track_mask, det_mask), scores

    def match_scores(self, tracks: torch.Tensor, track_mask: torch.Tensor,
                     detections: torch.Tensor, det_mask: torch.Tensor, lanes: int = 1
                     ) -> torch.Tensor:
        """The encoder and the GNN: the raw scores [B, T, N] before Sinkhorn."""
        c = self.config
        B, T, W, _ = tracks.shape
        D = c.descriptor_dim

        dt = c.dtype
        trk = self.encoder(tracks[..., 1:]) + position.timestep_encoding(tracks[..., 0], D).to(dt)
        det = self.encoder(detections[..., 1:]) + position.timestep_encoding(
            detections[..., 0], D).to(dt)

        # history fusion: self-attention over each track's window (B*T rows,
        # the plain path), then the mean over the full window
        fused = trk.reshape(B * T, W, D)
        for i, _ in enumerate(c.self_gnn_layers):
            fused = fused + getattr(self, f"fuser_layer{i}")(fused, fused, lanes=lanes)
        fused = fused.mean(dim=1).reshape(B, T, D)

        trk_kpm = ~track_mask
        t_feat, d_feat = fused, det
        for i, kind in enumerate(c.gnn_layers):
            layer = getattr(self, f"gnn_layer{i}")
            if kind == "cross":
                t_src, t_kpm, d_src, d_kpm = d_feat, None, t_feat, trk_kpm
            else:
                t_src, t_kpm, d_src, d_kpm = t_feat, trk_kpm, d_feat, None
            t_feat, d_feat = (t_feat + layer(t_feat, t_src, t_kpm, lanes),
                              d_feat + layer(d_feat, d_src, d_kpm, lanes))

        t_feat = self.final_proj(t_feat)
        d_feat = self.final_proj(d_feat)
        return torch.einsum("btd,bnd->btn", t_feat, d_feat).float() / D ** 0.5

    def _transport(self, scores: torch.Tensor, track_mask: torch.Tensor,
                   det_mask: torch.Tensor) -> torch.Tensor:
        """Sinkhorn with the dustbin: the log assignment [B, T+1, N+1]."""
        return sinkhorn.log_optimal_transport(scores, self.bin_score.float(),
                                              iters=self.config.sinkhorn_iterations,
                                              row_mask=track_mask, col_mask=det_mask)

    def _decode(self, Z, track_mask, det_mask, threshold: float) -> torch.Tensor:
        decode = lap.greedy_peel_match if self.config.decode == "greedy" else lap.match_by_score
        return decode(torch.exp(Z[:, :-1, :-1]), threshold, track_mask, det_mask)


def association_nll(Z: torch.Tensor, gt_pairs: torch.Tensor,
                    pair_valid: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of the ground-truth matches.

    Args:
        Z: [B, T+1, N+1] log assignment.
        gt_pairs: [B, P, 2] (track or bin, detection or bin) index pairs.
        pair_valid: [B, P] bool.
    """
    batch = torch.arange(Z.shape[0], device=Z.device)[:, None]
    picked = Z[batch, gt_pairs[..., 0].long(), gt_pairs[..., 1].long()]      # [B, P]
    return -(picked * pair_valid).sum()


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
