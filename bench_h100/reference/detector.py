"""The plain reference detector: DETR with a frozen-BN ResNet-50, in float32.

Written after ``odam_torch/models/{resnet,transformer,position,detr}.py``
(their float32 plain path: the literal 7x7 stem, attention as einsum and
softmax, no kernel) under the same state-dict names, so one set of weights
loads into both.  ``dilation`` swaps the last stage's stride for dilation 2
(DETR-DC5).  ``decode``, ``select`` and ``gather`` are the port's
``postprocess`` in three parts, and ``nms_3d_mask`` a copy of its NMS.
It imports nothing of ``odam_torch``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import boxes as box_ops
from .layers import Conv, Dense

RESNET50_STAGES = (3, 4, 6, 3)
LN_EPS = 1e-6
NEG_INF = -1e9


@dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = 18
    num_queries: int = 100
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    num_angle_bins: int = 30
    dilation: bool = False

    @classmethod
    def from_model(cls, model: dict) -> "DetectorConfig":
        """From a configuration's ``model`` keys (the YAML schema)."""
        return cls(num_classes=int(model.get("num_classes", 18)),
                   num_queries=int(model["num_queries"]), hidden_dim=int(model["hidden_dim"]),
                   nheads=int(model["nheads"]), enc_layers=int(model["enc_layers"]),
                   dec_layers=int(model["dec_layers"]),
                   dim_feedforward=int(model["dim_feedforward"]),
                   dilation=bool(model["dilation"]))


class FrozenBatchNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _conv(cin, cout, k, stride=1, dilation=1):
    return Conv(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation,
                bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        out = mid * 4
        self.conv1, self.bn1 = _conv(cin, mid, 1), FrozenBatchNorm(mid)
        self.conv2, self.bn2 = _conv(mid, mid, 3, stride, dilation), FrozenBatchNorm(mid)
        self.conv3, self.bn3 = _conv(mid, out, 1), FrozenBatchNorm(out)
        self.project = cin != out or stride != 1
        if self.project:
            self.downsample_conv = _conv(cin, out, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + identity)


class ResNet50(nn.Module):
    """Stage 4's output, NCHW."""

    def __init__(self, dilate_last: bool = False):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin, mid = 64, 64
        for stage, n_blocks in enumerate(RESNET50_STAGES, start=1):
            dilate = dilate_last and stage == len(RESNET50_STAGES)
            for blk in range(n_blocks):
                stride = 2 if (blk == 0 and stage > 1 and not dilate) else 1
                self.add_module(f"layer{stage}_{blk}",
                                Bottleneck(cin, mid, stride, 2 if dilate else 1))
                cin = mid * 4
            mid *= 2

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        for stage, n_blocks in enumerate(RESNET50_STAGES, start=1):
            for blk in range(n_blocks):
                x = getattr(self, f"layer{stage}_{blk}")(x)
        return x


def attention(q, k, v, num_heads: int, key_padding_mask=None):
    """Scaled dot-product attention over heads: q [B, Lq, D], k and v
    [B, Lk, D], mask [B, Lk] True = padded -> [B, Lq, D]."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    dh = D // num_heads
    qh, kh = q.reshape(B, Lq, num_heads, dh), k.reshape(B, Lk, num_heads, dh)
    vh = v.reshape(B, Lk, num_heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, Lq, D)


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj, self.k_proj = Dense(d, d), Dense(d, d)
        self.v_proj, self.out_proj = Dense(d, d), Dense(d, d)

    def forward(self, query, key, value, key_padding_mask=None):
        out = attention(self.q_proj(query), self.k_proj(key), self.v_proj(value),
                        self.num_heads, key_padding_mask)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, heads)
        self.linear1, self.linear2 = Dense(d, ffn), Dense(ffn, d)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=LN_EPS), nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, src, pos, mask):
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src, mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, heads)
        self.multihead_attn = MultiHeadAttention(d, heads)
        self.linear1, self.linear2 = Dense(d, ffn), Dense(ffn, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt, memory, pos, query_pos, mask):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory, mask))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Transformer(nn.Module):
    """Post-norm DETR transformer; returns the decoder's normed states
    [L_dec, B, Q, D]."""

    def __init__(self, c: DetectorConfig):
        super().__init__()
        self.c = c
        args = (c.hidden_dim, c.nheads, c.dim_feedforward)
        for i in range(c.enc_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(*args))
        for i in range(c.dec_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(*args))
        self.decoder_norm = nn.LayerNorm(c.hidden_dim, eps=LN_EPS)

    def forward(self, src, mask, query_embed, pos):
        B, H, W, D = src.shape
        memory, pos = src.reshape(B, H * W, D), pos.reshape(B, H * W, D)
        mask = mask.reshape(B, H * W)
        for i in range(self.c.enc_layers):
            memory = getattr(self, f"encoder_layer{i}")(memory, pos, mask)
        query_pos = query_embed[None].expand(B, -1, -1)
        out = torch.zeros_like(query_pos)
        states = []
        for i in range(self.c.dec_layers):
            out = getattr(self, f"decoder_layer{i}")(out, memory, pos, query_pos, mask)
            states.append(self.decoder_norm(out))
        return torch.stack(states)


def sine_position_encoding(mask, num_pos_feats: int = 128, temperature: float = 10000.0):
    """2D sine positions from a padding mask [B, H, W] -> [B, H, W, 2F]."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)


class HeadMLP(nn.Module):
    def __init__(self, d_in, d, d_out, num_layers=3):
        super().__init__()
        self.num_layers = num_layers
        dims = [d_in] + [d] * (num_layers - 1) + [d_out]
        for i in range(num_layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class DETR(nn.Module):
    def __init__(self, c: DetectorConfig):
        super().__init__()
        self.c = c
        D = c.hidden_dim
        self.backbone = ResNet50(c.dilation)
        self.input_proj = Conv(2048, D, 1)
        self.query_embed = nn.Parameter(torch.zeros(c.num_queries, D))
        self.transformer = Transformer(c)
        self.class_embed = Dense(D, c.num_classes + 1)
        self.bbox_embed = HeadMLP(D, D, 4)
        self.offset_embed = HeadMLP(D, D, 2)
        self.angle_embed = HeadMLP(D, D, c.num_angle_bins)
        self.size_embed = HeadMLP(D, D, 3)
        self.depth_embed = HeadMLP(D, D, 1)

    def forward(self, images: torch.Tensor) -> dict:
        """images [B, H, W, 3] normalized -> the last decoder layer's heads."""
        B, H, W, _ = images.shape
        feats = self.backbone(images.float().permute(0, 3, 1, 2))
        fh, fw = feats.shape[-2:]
        mask = torch.zeros((B, fh, fw), dtype=torch.bool, device=images.device)
        pos = sine_position_encoding(mask, self.c.hidden_dim // 2)
        src = self.input_proj(feats).permute(0, 2, 3, 1)
        hs = self.transformer(src, mask, self.query_embed, pos)[-1]
        return {"pred_logits": self.class_embed(hs),
                "pred_boxes": torch.sigmoid(self.bbox_embed(hs)),
                "pred_angle": self.angle_embed(hs), "pred_offset": self.offset_embed(hs),
                "pred_size": self.size_embed(hs), "pred_depth": self.depth_embed(hs),
                "pred_obj_features": hs}


class Detections(NamedTuple):
    valid: torch.Tensor       # [B, N] bool
    classes: torch.Tensor     # [B, N] int32
    scores: torch.Tensor      # [B, N]
    boxes: torch.Tensor       # [B, N, 4] xyxy pixels
    dims: torch.Tensor        # [B, N, 3]
    t_co: torch.Tensor        # [B, N, 3]
    angle_deg: torch.Tensor   # [B, N]
    features: torch.Tensor    # [B, N, D]


# ---- a copy of odam_torch/models/detr.py's postprocess and fixpoint NMS

def _suppression_pairs(classes, t_co, dims, boxes_2d, iou3d_threshold, iou2d_threshold):
    Q = classes.shape[-1]
    half = dims / 2.0
    aabb = torch.stack([t_co - half, t_co + half], dim=-2)
    iou3 = box_ops.iou_aabb(aabb[..., :, None, :, :], aabb[..., None, :, :, :])
    sup_pair = (classes[..., :, None] == classes[..., None, :]) & (iou3 > iou3d_threshold)
    iou2, _ = box_ops.pairwise_box_iou(boxes_2d, boxes_2d)
    sup_pair = sup_pair | (iou2 > iou2d_threshold)
    return sup_pair & ~torch.eye(Q, dtype=torch.bool, device=classes.device)


def nms_3d_mask(classes, scores, t_co, dims, boxes_2d, valid, iou3d_threshold=0.25,
                iou2d_threshold=0.5):
    Q = classes.shape[-1]
    sup_pair = _suppression_pairs(classes, t_co, dims, boxes_2d, iou3d_threshold,
                                  iou2d_threshold)
    idx = torch.arange(Q, device=classes.device)
    outranks = (scores[..., None, :] > scores[..., :, None]) | (
        (scores[..., None, :] == scores[..., :, None]) & (idx[None, :] < idx[:, None]))
    S = sup_pair & outranks & valid[..., None, :]
    keep = valid
    for _ in range(Q + 1):
        keep = valid & ~(S & keep[..., None, :]).any(dim=-1)
    return keep


class Candidates(NamedTuple):
    """Every query's decoded detection, before the NMS and the top-k."""
    probs: torch.Tensor         # [B, Q, C] class probabilities, no-object left out
    scores: torch.Tensor        # [B, Q]
    classes: torch.Tensor       # [B, Q] int32
    boxes: torch.Tensor         # [B, Q, 4] xyxy pixels
    dims: torch.Tensor          # [B, Q, 3]
    t_co: torch.Tensor          # [B, Q, 3]
    angle_logits: torch.Tensor  # [B, Q, bins]
    angle_deg: torch.Tensor     # [B, Q]
    features: torch.Tensor      # [B, Q, D]


def decode(outputs: dict, img_w: float, img_h: float, K: torch.Tensor) -> Candidates:
    """Raw heads (any dtype, read in float32) -> every query's detection;
    ``K`` is [B, 3, 3]."""
    logits = outputs["pred_logits"].float()
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)[..., :-1]
    scale = box_ops.xyxy_scale(img_w, img_h, dev)
    boxes = box_ops.cxcywh_to_xyxy(outputs["pred_boxes"].float()) * scale
    offset = outputs["pred_offset"].float() * scale[:2]
    shape_center = offset + (boxes[..., :2] + boxes[..., 2:]) / 2.0
    Kb = K.reshape(-1, 3, 3)
    f = torch.stack([Kb[:, 0, 0], Kb[:, 1, 1]], dim=-1)[:, None]
    cxy = torch.stack([Kb[:, 0, 2], Kb[:, 1, 2]], dim=-1)[:, None]
    depth = outputs["pred_depth"].float()
    angle = outputs["pred_angle"].float()
    n_bins = angle.shape[-1]
    return Candidates(probs=probs, scores=probs.amax(dim=-1), classes=probs.argmax(dim=-1).int(),
                      boxes=boxes, dims=outputs["pred_size"].float(),
                      t_co=torch.cat([(shape_center - cxy) / f * depth, depth], dim=-1),
                      angle_logits=angle,
                      angle_deg=angle.argmax(dim=-1).float() * (180.0 / n_bins),
                      features=outputs["pred_obj_features"].float())


def select(c: Candidates, threshold: float, max_dets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The score threshold, the fixpoint NMS and the top ``max_dets`` by
    score: (query index of each slot [B, N], slot valid [B, N])."""
    keep = nms_3d_mask(c.classes, c.scores, c.t_co, c.dims, c.boxes, c.scores > threshold)
    order = torch.argsort(torch.where(keep, -c.scores, torch.inf), dim=-1, stable=True)
    order = order[:, :max_dets]
    valid = torch.gather(keep, 1, order)
    if order.shape[1] < max_dets:
        pad = max_dets - order.shape[1]
        order, valid = F.pad(order, (0, pad)), F.pad(valid, (0, pad))
    return order, valid


def gather(c: Candidates, order: torch.Tensor, valid: torch.Tensor) -> Detections:
    """The detections of the queries ``order`` [B, N] names."""
    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2)).expand(order.shape + x.shape[2:])
        return torch.gather(x, 1, idx)

    return Detections(valid=valid, classes=take(c.classes), scores=take(c.scores),
                      boxes=take(c.boxes), dims=take(c.dims), t_co=take(c.t_co),
                      angle_deg=take(c.angle_deg), features=take(c.features))


