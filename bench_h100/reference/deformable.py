"""The plain reference of Deformable DETR as ODAM's detector, in float32.

Zhu et al., "Deformable DETR" (ICLR 2021, arXiv:2010.04159), plain form (no
box refinement, not two-stage), written from the paper and
fundamentalvision/Deformable-DETR's ``deformable_detr.py``,
``deformable_transformer.py``, ``ms_deform_attn.py`` and
``position_encoding.py``, under the state-dict names of
``odam_torch/models/deformable_detr.py`` so one set of weights loads into
both.  It imports nothing of ``odam_torch``; the frozen-BN ResNet-50, the
attention, the heads and ``decode`` / ``select`` are :mod:`.detector`'s.

- Levels: ResNet-50's C3, C4, C5 through a 1x1 conv and GroupNorm(32, eps
  1e-5), and a fourth from C5 through a 3x3 stride-2 conv and GroupNorm.
- Positions: the sine encoding with pixel centres ((cumsum - 0.5) / extent
  x 2 pi), plus ``level_embed[l]``.
- MSDA: ``value_proj`` (0 at padded pixels), the offsets over (w_l, h_l)
  added to the reference point, a softmax over each head's L x P weights,
  and the samples by ``grid_sample`` (bilinear, zero padding,
  ``align_corners=False`` at ``2 loc - 1``) per level and per head, as
  upstream's ``ms_deform_attn_core_pytorch``; then ``output_proj``.
- Encoder: every pixel a query at its centre over its level's valid extent
  times each level's valid ratio; post-norm MSDA then FFN (ReLU).
- Decoder: ``query_embed`` [Q, 2D] split (query_pos, tgt); reference points
  ``sigmoid(reference_points(query_pos))``; self-attention (q = k = tgt +
  query_pos), MSDA cross-attention, FFN, each followed by LayerNorm; no
  final norm.
- Heads: ODAM's six on the last decoder layer; ``pred_boxes =
  sigmoid(bbox_embed(hs) + [inverse_sigmoid(reference), 0, 0])``.

Departures from upstream, as in the program: LayerNorm eps 1e-6 (upstream
1e-5) and ODAM's C + 1 softmax class head (upstream: a sigmoid focal head).
The forward runs with TF32 off unless ``allow_tf32`` is set (the control).
``round_locations`` rounds every sampling location to bfloat16 before the
sampling: a control of the program's float32 locations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .detector import LN_EPS, RESNET50_STAGES, HeadMLP, MultiHeadAttention, ResNet50
from .layers import Conv, Dense

GN_EPS = 1e-5
BOX_EPS = 1e-5


@dataclass(frozen=True)
class DeformableConfig:
    num_classes: int = 18
    num_queries: int = 300
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 1024
    num_angle_bins: int = 30
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4

    @classmethod
    def from_model(cls, model: dict) -> "DeformableConfig":
        """From a configuration's ``model`` keys (Deformable DETR's names)."""
        if model.get("dilation") or model.get("with_box_refine") or model.get("two_stage"):
            raise ValueError("the reference is the plain, undilated Deformable DETR")
        return cls(num_classes=int(model.get("num_classes", 18)),
                   num_queries=int(model["num_queries"]), hidden_dim=int(model["hidden_dim"]),
                   nheads=int(model["nheads"]), enc_layers=int(model["enc_layers"]),
                   dec_layers=int(model["dec_layers"]),
                   dim_feedforward=int(model["dim_feedforward"]),
                   num_feature_levels=int(model["num_feature_levels"]),
                   enc_n_points=int(model["enc_n_points"]),
                   dec_n_points=int(model["dec_n_points"]))


def sampling_offsets_grid(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Upstream's ``_reset_parameters`` bias of ``sampling_offsets``, flat
    [H L P 2]: head h along the angle 2 pi h / H, the direction scaled so
    that the larger of |x| and |y| is 1, point k at k + 1 times it."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid.view(n_heads, 1, 1, 2).repeat(1, n_levels, n_points, 1)
    for k in range(n_points):
        grid[:, :, k, :] *= k + 1
    return grid.reshape(-1)


def sine_positions(mask: torch.Tensor, num_pos_feats: int) -> torch.Tensor:
    """Upstream's normalised sine encoding, pixel centres: [B, h, w, 2F]."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)


def msda_core(value, shapes, locations, weights):
    """value [B, S, H, dh]; locations [B, Lq, H, L, P, 2]; weights [B, Lq, H,
    L, P] -> [B, Lq, H dh]: grid_sample per level and per head."""
    B, _, H, dh = value.shape
    Lq = locations.shape[1]
    out = value.new_zeros(B, Lq, H, dh)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v_l = value[:, start:start + h * w]
        start += h * w
        for head in range(H):
            grid = 2.0 * locations[:, :, head, lvl] - 1.0                  # [B, Lq, P, 2]
            maps = v_l[:, :, head].transpose(1, 2).reshape(B, dh, h, w)
            sampled = F.grid_sample(maps, grid, mode="bilinear", padding_mode="zeros",
                                    align_corners=False)                    # [B, dh, Lq, P]
            out[:, :, head] += (sampled * weights[:, None, :, head, lvl]).sum(-1).transpose(1, 2)
    return out.reshape(B, Lq, H * dh)


class MSDeformAttn(nn.Module):
    def __init__(self, d: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.value_proj = Dense(d, d)
        self.sampling_offsets = Dense(d, n_heads * n_levels * n_points * 2)
        self.attention_weights = Dense(d, n_heads * n_levels * n_points)
        self.output_proj = Dense(d, d)
        self.round_locations = False

    def forward(self, query, reference, source, shapes, padding_mask):
        B, Lq, D = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(source).masked_fill(padding_mask[..., None], 0.0)
        value = value.view(B, -1, H, D // H)
        offsets = self.sampling_offsets(query).view(B, Lq, H, L, P, 2)
        weights = torch.softmax(self.attention_weights(query).view(B, Lq, H, L * P), -1)
        weights = weights.view(B, Lq, H, L, P)
        size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=query.device)
        locations = reference[:, :, None, :, None, :] + offsets / size[None, None, None, :,
                                                                        None, :]
        if self.round_locations:
            locations = locations.to(torch.bfloat16).float()
        return self.output_proj(msda_core(value, shapes, locations, weights))


class EncoderLayer(nn.Module):
    def __init__(self, c: DeformableConfig):
        super().__init__()
        d = c.hidden_dim
        self.self_attn = MSDeformAttn(d, c.num_feature_levels, c.nheads, c.enc_n_points)
        self.linear1, self.linear2 = Dense(d, c.dim_feedforward), Dense(c.dim_feedforward, d)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=LN_EPS), nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, src, pos, reference, shapes, mask):
        src = self.norm1(src + self.self_attn(src + pos, reference, src, shapes, mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, c: DeformableConfig):
        super().__init__()
        d = c.hidden_dim
        self.self_attn = MultiHeadAttention(d, c.nheads)
        self.cross_attn = MSDeformAttn(d, c.num_feature_levels, c.nheads, c.dec_n_points)
        self.linear1, self.linear2 = Dense(d, c.dim_feedforward), Dense(c.dim_feedforward, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt, query_pos, reference, memory, shapes, mask):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + query_pos, reference, memory, shapes, mask))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Transformer(nn.Module):
    def __init__(self, c: DeformableConfig):
        super().__init__()
        self.c = c
        for i in range(c.enc_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(c))
        for i in range(c.dec_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(c))
        self.reference_points = Dense(c.hidden_dim, 2)

    def forward(self, srcs, masks, pos, query_embed):
        """srcs, pos: levels [B, h, w, D]; masks [B, h, w] -> (the decoder's
        states [L_dec, B, Q, D], its reference points [B, Q, 2])."""
        B, D = srcs[0].shape[0], self.c.hidden_dim
        shapes = [tuple(s.shape[1:3]) for s in srcs]
        memory = torch.cat([s.reshape(B, -1, D) for s in srcs], 1)
        pos = torch.cat([p.reshape(B, -1, D) for p in pos], 1)
        mask = torch.cat([m.reshape(B, -1) for m in masks], 1)
        ratios = torch.stack([torch.stack([(~m[:, 0, :]).sum(1).float() / m.shape[2],
                                           (~m[:, :, 0]).sum(1).float() / m.shape[1]], -1)
                              for m in masks], 1)                             # [B, L, 2]
        points = []
        for lvl, (h, w) in enumerate(shapes):
            ys = torch.linspace(0.5, h - 0.5, h, device=memory.device)
            xs = torch.linspace(0.5, w - 0.5, w, device=memory.device)
            ry, rx = torch.meshgrid(ys, xs, indexing="ij")
            points.append(torch.stack([rx.reshape(-1)[None] / (ratios[:, None, lvl, 0] * w),
                                       ry.reshape(-1)[None] / (ratios[:, None, lvl, 1] * h)],
                                      -1))
        reference = torch.cat(points, 1)[:, :, None] * ratios[:, None]
        for i in range(self.c.enc_layers):
            memory = getattr(self, f"encoder_layer{i}")(memory, pos, reference, shapes, mask)
        query_pos, tgt = torch.split(query_embed, D, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        out = tgt[None].expand(B, -1, -1)
        ref = torch.sigmoid(self.reference_points(query_pos))
        ref_in = ref[:, :, None] * ratios[:, None]
        states = []
        for i in range(self.c.dec_layers):
            out = getattr(self, f"decoder_layer{i}")(out, query_pos, ref_in, memory, shapes, mask)
            states.append(out)
        return torch.stack(states), ref


class InputProj(nn.Module):
    def __init__(self, cin: int, d: int, kernel: int, stride: int):
        super().__init__()
        self.conv = Conv(cin, d, kernel, stride=stride, padding=kernel // 2)
        self.norm = nn.GroupNorm(32, d, eps=GN_EPS)

    def forward(self, x):
        return self.norm(self.conv(x))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(min=0.0, max=1.0)
    return torch.log(x.clamp(min=BOX_EPS) / (1.0 - x).clamp(min=BOX_EPS))


class DeformableDETR(nn.Module):
    STAGES = (2, 3, 4)         # C3, C4, C5

    def __init__(self, c: DeformableConfig):
        super().__init__()
        self.c = c
        D = c.hidden_dim
        self.allow_tf32 = False
        self.backbone = ResNet50()
        projs = [InputProj(256 * 2 ** (s - 1), D, 1, 1) for s in self.STAGES]
        cin = 2048
        for _ in range(c.num_feature_levels - len(self.STAGES)):
            projs.append(InputProj(cin, D, 3, 2))
            cin = D
        self.input_proj = nn.ModuleList(projs)
        self.level_embed = nn.Parameter(torch.zeros(c.num_feature_levels, D))
        self.query_embed = nn.Parameter(torch.zeros(c.num_queries, 2 * D))
        self.transformer = Transformer(c)
        self.class_embed = Dense(D, c.num_classes + 1)
        self.bbox_embed = HeadMLP(D, D, 4)
        self.offset_embed = HeadMLP(D, D, 2)
        self.angle_embed = HeadMLP(D, D, c.num_angle_bins)
        self.size_embed = HeadMLP(D, D, 3)
        self.depth_embed = HeadMLP(D, D, 1)

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """C3, C4, C5 of the frozen-BN ResNet-50 (:class:`.detector.ResNet50`'s
        modules, run stage by stage)."""
        bb = self.backbone
        x = F.max_pool2d(F.relu(bb.bn1(bb.conv1(x))), 3, stride=2, padding=1)
        out = []
        for stage, n_blocks in enumerate(RESNET50_STAGES, start=1):
            for blk in range(n_blocks):
                x = getattr(bb, f"layer{stage}_{blk}")(x)
            if stage in self.STAGES:
                out.append(x)
        return out

    def forward(self, images: torch.Tensor) -> dict:
        """images [B, H, W, 3] normalized -> the last decoder layer's heads."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.allow_tf32
        try:
            return self._forward(images)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def _forward(self, images):
        c = self.c
        B = images.shape[0]
        feats = self.features(images.float().permute(0, 3, 1, 2))
        srcs = [proj(f) for proj, f in zip(self.input_proj, feats)]
        x = feats[-1]
        for proj in self.input_proj[len(feats):]:
            x = proj(x)
            srcs.append(x)
        masks = [torch.zeros((B,) + s.shape[-2:], dtype=torch.bool, device=images.device)
                 for s in srcs]
        pos = [sine_positions(m, c.hidden_dim // 2) + self.level_embed[lvl]
               for lvl, m in enumerate(masks)]
        hs, ref = self.transformer([s.permute(0, 2, 3, 1) for s in srcs], masks, pos,
                                   self.query_embed)
        hs = hs[-1]
        box = self.bbox_embed(hs)
        box = torch.cat([box[..., :2] + inverse_sigmoid(ref), box[..., 2:]], -1)
        return {"pred_logits": self.class_embed(hs), "pred_boxes": torch.sigmoid(box),
                "pred_angle": self.angle_embed(hs), "pred_offset": self.offset_embed(hs),
                "pred_size": self.size_embed(hs), "pred_depth": self.depth_embed(hs),
                "pred_obj_features": hs}

    def msda_modules(self) -> list[MSDeformAttn]:
        return [m for m in self.modules() if isinstance(m, MSDeformAttn)]
