"""Deformable DETR as ODAM's per-frame detector.

Zhu et al., "Deformable DETR: Deformable Transformers for End-to-End Object
Detection" (ICLR 2021, arXiv:2010.04159), as fundamentalvision/Deformable-DETR
builds it with ``configs/r50_deformable_detr.sh`` and ``main.py``'s defaults,
in its plain form: a frozen-BN ResNet-50 returning C3, C4 and C5 (strides
8 / 16 / 32), a 1x1 conv and GroupNorm(32) on each, a 3x3 stride-2 conv and
GroupNorm on C5 for each level past those (``num_feature_levels`` 4 in
all), the sine positions (pixel centres, ``offset`` 0.5) plus a learned
``level_embed``, the deformable encoder and decoder
(:mod:`.deformable_transformer`), 300 queries from ``query_embed`` [Q, 2D]
(query_pos, tgt), and the box head relative to each query's reference
point: ``boxes = sigmoid(bbox_embed(hs) + [inverse_sigmoid(reference), 0, 0])``.
Box refinement and the two-stage variant are not ported.  The JAX package
has no counterpart; there is no Flax model to convert from.

The heads are ODAM's six, as :class:`.detr.DETR` has them (class with C + 1
softmax logits, box, centre offset, azimuth bins, size, depth), and
``forward`` returns the same dict, ``aux_outputs`` included.  ``dtype``,
``use_kernels``, ``lanes`` and ``shards`` mean what they mean for
:class:`.detr.DETR`: with ``use_kernels`` the multi-scale deformable
attention runs on :mod:`odam_torch.ops.msda`'s kernel and the decoder's
self-attention on the attention kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from . import position, resnet
from .deformable_transformer import DeformableTransformer
from .detr import HeadMLP
from .layers import Conv, Dense, GroupNorm

GN_GROUPS = 32
GN_EPS = 1e-5          # nn.GroupNorm's default, as upstream's input projections
SINE_OFFSET = 0.5      # upstream's position_encoding.py: (cumsum - 0.5) / extent
BOX_EPS = 1e-5         # upstream's inverse_sigmoid


@dataclass(frozen=True)
class DeformableDETRConfig:
    num_classes: int = 18
    num_queries: int = 300
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 1024
    dropout: float = 0.1           # in .train() mode only
    aux_loss: bool = True
    num_angle_bins: int = 30
    backbone: str = "resnet50"     # "resnet50" | "tiny"
    dilation: bool = False         # ResNet-50's last stage dilated, not strided
    stem: str = "conv"
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    dtype: torch.dtype = torch.float32
    use_kernels: bool = True

    @classmethod
    def from_cfg(cls, cfg: dict, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True) -> "DeformableDETRConfig":
        """From a YAML with Deformable DETR's ``main.py`` names
        (``odam_torch/configs/deformable_detr_scan_net.yaml``)."""
        for key in ("with_box_refine", "two_stage"):
            if cfg.get(key, False):
                raise NotImplementedError(
                    f"Deformable DETR's {key} is not ported: the port runs its plain form "
                    "(ROADMAP Queue 6 lists box refinement and two-stage)")
        return cls(
            num_classes=int(cfg.get(
                "num_classes", 18 if cfg.get("dataset_file", "scan_net") == "scan_net" else 20)),
            num_queries=int(cfg.get("num_queries", 300)),
            hidden_dim=int(cfg.get("hidden_dim", 256)),
            nheads=int(cfg.get("nheads", 8)),
            enc_layers=int(cfg.get("enc_layers", 6)),
            dec_layers=int(cfg.get("dec_layers", 6)),
            dim_feedforward=int(cfg.get("dim_feedforward", 1024)),
            dropout=float(cfg.get("dropout", 0.1)),
            aux_loss=bool(cfg.get("aux_loss", True)),
            backbone=cfg.get("backbone", "resnet50"),
            dilation=bool(cfg.get("dilation", False)),
            stem=cfg.get("stem", "conv"),
            num_feature_levels=int(cfg.get("num_feature_levels", 4)),
            enc_n_points=int(cfg.get("enc_n_points", 4)),
            dec_n_points=int(cfg.get("dec_n_points", 4)),
            dtype=dtype,
            use_kernels=use_kernels,
        )


def backbone_stages(num_feature_levels: int) -> tuple[int, ...]:
    """The backbone stages the levels start from: C5 alone for one level,
    C3, C4 and C5 for three or more (upstream builds no other count)."""
    if num_feature_levels == 1:
        return (4,)
    if num_feature_levels >= 3:
        return (2, 3, 4)
    raise ValueError(f"num_feature_levels {num_feature_levels}: Deformable DETR takes 1 or "
                     "at least 3")


def inverse_sigmoid(x: torch.Tensor, eps: float = BOX_EPS) -> torch.Tensor:
    x = x.clamp(min=0.0, max=1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


class InputProj(nn.Module):
    """A conv and GroupNorm(32) onto the transformer's width."""

    def __init__(self, cin: int, d: int, kernel: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv(cin, d, kernel, stride=stride, padding=kernel // 2, dtype=dtype)
        self.norm = GroupNorm(GN_GROUPS, d, GN_EPS, dtype)

    def forward(self, x):
        return self.norm(self.conv(x))


class DeformableDETR(nn.Module):
    def __init__(self, config: DeformableDETRConfig = DeformableDETRConfig()):
        super().__init__()
        c = self.config = config
        dt = c.dtype
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dt} is not float32 or bfloat16")
        self.stages = backbone_stages(c.num_feature_levels)
        if c.backbone == "tiny":
            self.backbone = resnet.TinyBackbone(return_stages=self.stages, dtype=dt)
        elif c.backbone == "resnet50":
            self.backbone = resnet.resnet50(dt, c.dilation, self.stages, c.stem)
        else:
            raise ValueError(f"unknown backbone {c.backbone!r}")
        D = c.hidden_dim
        projs = [InputProj(self.backbone.channels(s), D, 1, 1, dt) for s in self.stages]
        cin = self.backbone.channels(self.stages[-1])
        for _ in range(c.num_feature_levels - len(self.stages)):
            projs.append(InputProj(cin, D, 3, 2, dt))
            cin = D
        self.input_proj = nn.ModuleList(projs)
        self.level_embed = nn.Parameter(torch.zeros(c.num_feature_levels, D))
        self.query_embed = nn.Parameter(torch.zeros(c.num_queries, 2 * D))
        self.transformer = DeformableTransformer(
            D, c.nheads, c.enc_layers, c.dec_layers, c.dim_feedforward, c.dropout,
            c.num_feature_levels, c.enc_n_points, c.dec_n_points, dt, c.use_kernels)
        self.class_embed = Dense(D, c.num_classes + 1, dtype=dt)
        self.bbox_embed = HeadMLP(D, D, 4, dtype=dt)
        self.offset_embed = HeadMLP(D, D, 2, dtype=dt)
        self.angle_embed = HeadMLP(D, D, c.num_angle_bins, dtype=dt)
        self.size_embed = HeadMLP(D, D, 3, dtype=dt)
        self.depth_embed = HeadMLP(D, D, 1, dtype=dt)

    def forward(self, images: torch.Tensor, pixel_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None, lanes: int = 1,
                shards: int = 1) -> dict:
        """As :meth:`.detr.DETR.forward`: images [B, H, W, 3] normalized,
        pixel_mask [B, H, W] bool (True = padded) -> the six heads of the
        last decoder layer, ``pred_obj_features`` [B, Q, D] and
        ``aux_outputs``, in the compute dtype."""
        c = self.config
        B, H, W, _ = images.shape
        if pixel_mask is None:
            pixel_mask = torch.zeros((B, H, W), dtype=torch.bool, device=images.device)
        feats = self.backbone(images.permute(0, 3, 1, 2))
        srcs = [proj(feats[s]) for proj, s in zip(self.input_proj, self.stages)]
        x = feats[self.stages[-1]]
        for proj in self.input_proj[len(self.stages):]:
            x = proj(x)
            srcs.append(x)
        masks, pos = [], []
        for lvl, src in enumerate(srcs):
            mask = F.interpolate(pixel_mask[:, None].float(), size=src.shape[-2:],
                                 mode="nearest-exact")[:, 0].bool()
            sine = position.sine_position_encoding(mask, c.hidden_dim // 2,
                                                   offset=SINE_OFFSET)
            masks.append(mask)
            pos.append((sine + self.level_embed[lvl]).to(c.dtype))
        srcs = [s.permute(0, 2, 3, 1) for s in srcs]
        hs, reference = self.transformer(srcs, masks, pos, self.query_embed, generator, lanes,
                                         shards)

        logits = self.class_embed(hs)
        box = self.bbox_embed(hs).float()
        box = torch.cat([box[..., :2] + inverse_sigmoid(reference), box[..., 2:]], dim=-1)
        boxes = torch.sigmoid(box).to(c.dtype)
        angle = self.angle_embed(hs)
        offset = self.offset_embed(hs)
        size = self.size_embed(hs)
        depth = self.depth_embed(hs)
        out = {
            "pred_logits": logits[-1],
            "pred_boxes": boxes[-1],
            "pred_angle": angle[-1],
            "pred_offset": offset[-1],
            "pred_size": size[-1],
            "pred_depth": depth[-1],
            "pred_obj_features": hs[-1],
        }
        if c.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": logits[i], "pred_boxes": boxes[i], "pred_angle": angle[i],
                 "pred_offset": offset[i], "pred_size": size[i], "pred_depth": depth[i]}
                for i in range(hs.shape[0] - 1)
            ]
        return out

