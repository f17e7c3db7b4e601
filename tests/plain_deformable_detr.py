"""A plain float32 Deformable DETR for the tests: the reference that
``tests/test_torch_deformable_detr.py`` holds ``odam_torch``'s
``DeformableDETR`` to.

Written from Zhu et al., "Deformable DETR" (ICLR 2021, arXiv:2010.04159)
and fundamentalvision/Deformable-DETR's model code, plain form (no box
refinement, not two-stage), under the port's state-dict names, with ODAM's
six heads.  Torch only: it imports neither JAX nor ``odam_torch``, and runs
with TF32 off.  Its multi-scale deformable attention is upstream's
``ms_deform_attn_core_pytorch`` cut further, one ``grid_sample`` per level
and per head.  Departures from upstream, as in the port: LayerNorm eps 1e-6
and a C + 1 softmax class head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

STAGES = (3, 4, 6, 3)
LN_EPS = 1e-6


class FrozenBN(nn.Module):
    def __init__(self, n):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        return x * scale[:, None, None] + (self.bias - self.running_mean * scale)[:, None, None]


class Block(nn.Module):
    def __init__(self, cin, mid, stride):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(cin, mid, 1, bias=False), FrozenBN(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(mid)
        self.conv3, self.bn3 = nn.Conv2d(mid, 4 * mid, 1, bias=False), FrozenBN(4 * mid)
        self.project = cin != 4 * mid or stride != 1
        if self.project:
            self.downsample_conv = nn.Conv2d(cin, 4 * mid, 1, stride, bias=False)
            self.downsample_bn = FrozenBN(4 * mid)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (self.downsample_bn(self.downsample_conv(x)) if self.project else x))


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False), FrozenBN(64)
        cin, mid = 64, 64
        for s, n in enumerate(STAGES, start=1):
            for b in range(n):
                self.add_module(f"layer{s}_{b}", Block(cin, mid, 2 if b == 0 and s > 1 else 1))
                cin = 4 * mid
            mid *= 2

    def forward(self, x):
        """C3, C4, C5."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        out = []
        for s, n in enumerate(STAGES, start=1):
            for b in range(n):
                x = getattr(self, f"layer{s}_{b}")(x)
            if s >= 2:
                out.append(x)
        return out


def sine(mask, feats):
    """Upstream's normalised sine positions at pixel centres: [B, h, w, 2F]."""
    y = (~mask).float().cumsum(1)
    x = (~mask).float().cumsum(2)
    y = (y - 0.5) / (y[:, -1:, :] + 1e-6) * 2 * math.pi
    x = (x - 0.5) / (x[:, :, -1:] + 1e-6) * 2 * math.pi
    t = 10000.0 ** (2 * torch.floor(torch.arange(feats, dtype=torch.float32) / 2) / feats)
    px, py = x[..., None] / t, y[..., None] / t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], -1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], -1).flatten(-2)
    return torch.cat([py, px], -1)


def msda(value, shapes, locations, weights):
    """value [B, S, H, dh], locations [B, Lq, H, L, P, 2], weights [B, Lq, H,
    L, P] -> [B, Lq, H dh]."""
    B, _, H, dh = value.shape
    Lq = locations.shape[1]
    out = torch.zeros(B, Lq, H, dh)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w]
        start += h * w
        for head in range(H):
            maps = v[:, :, head].transpose(1, 2).reshape(B, dh, h, w)
            got = F.grid_sample(maps, 2 * locations[:, :, head, lvl] - 1, mode="bilinear",
                                padding_mode="zeros", align_corners=False)
            out[:, :, head] += (got * weights[:, None, :, head, lvl]).sum(-1).transpose(1, 2)
    return out.reshape(B, Lq, H * dh)


class MSDeformAttn(nn.Module):
    def __init__(self, d, levels, heads, points):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.value_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, reference, source, shapes, mask):
        B, Lq, D = query.shape
        H, L, P = self.heads, self.levels, self.points
        value = self.value_proj(source).masked_fill(mask[..., None], 0.0).view(B, -1, H, D // H)
        off = self.sampling_offsets(query).view(B, Lq, H, L, P, 2)
        a = torch.softmax(self.attention_weights(query).view(B, Lq, H, L * P), -1)
        size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
        loc = reference[:, :, None, :, None, :] + off / size[None, None, None, :, None, :]
        return self.output_proj(msda(value, shapes, loc, a.view(B, Lq, H, L, P)))


class Attention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, q, k, v):
        B, Lq, D = q.shape
        H, dh = self.heads, D // self.heads
        q = self.q_proj(q).view(B, Lq, H, dh)
        k = self.k_proj(k).view(B, -1, H, dh)
        v = self.v_proj(v).view(B, -1, H, dh)
        a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh), -1)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, Lq, D))


class Head(nn.Module):
    def __init__(self, d, out):
        super().__init__()
        self.layer0, self.layer1, self.layer2 = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, out)

    def forward(self, x):
        return self.layer2(F.relu(self.layer1(F.relu(self.layer0(x)))))


class Proj(nn.Module):
    def __init__(self, cin, d, k, stride):
        super().__init__()
        self.conv = nn.Conv2d(cin, d, k, stride, k // 2)
        self.norm = nn.GroupNorm(32, d, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class EncoderLayer(nn.Module):
    def __init__(self, d, heads, ffn, levels, points):
        super().__init__()
        self.self_attn = MSDeformAttn(d, levels, heads, points)
        self.linear1, self.linear2 = nn.Linear(d, ffn), nn.Linear(ffn, d)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=LN_EPS), nn.LayerNorm(d, eps=LN_EPS)


class DecoderLayer(nn.Module):
    def __init__(self, d, heads, ffn, levels, points):
        super().__init__()
        self.self_attn = Attention(d, heads)
        self.cross_attn = MSDeformAttn(d, levels, heads, points)
        self.linear1, self.linear2 = nn.Linear(d, ffn), nn.Linear(ffn, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)


class Transformer(nn.Module):
    def __init__(self, d, heads, enc, dec, ffn, levels, points):
        super().__init__()
        self.enc, self.dec = enc, dec
        for i in range(enc):
            self.add_module(f"encoder_layer{i}", EncoderLayer(d, heads, ffn, levels, points))
        for i in range(dec):
            self.add_module(f"decoder_layer{i}", DecoderLayer(d, heads, ffn, levels, points))
        self.reference_points = nn.Linear(d, 2)


class PlainDeformableDETR(nn.Module):
    """ResNet-50 backbone; the forward takes images [B, H, W, 3] and returns
    the heads of every decoder layer as [L_dec, B, Q, ...] tensors."""

    def __init__(self, num_classes=18, num_queries=300, d=256, heads=8, enc=6, dec=6, ffn=1024,
                 levels=4, points=4, bins=30):
        super().__init__()
        self.d = d
        self.backbone = ResNet50()
        projs = [Proj(c, d, 1, 1) for c in (512, 1024, 2048)]
        cin = 2048
        for _ in range(levels - 3):
            projs.append(Proj(cin, d, 3, 2))
            cin = d
        self.input_proj = nn.ModuleList(projs)
        self.level_embed = nn.Parameter(torch.zeros(levels, d))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, 2 * d))
        self.transformer = Transformer(d, heads, enc, dec, ffn, levels, points)
        self.class_embed = nn.Linear(d, num_classes + 1)
        self.bbox_embed, self.offset_embed = Head(d, 4), Head(d, 2)
        self.angle_embed, self.size_embed, self.depth_embed = Head(d, bins), Head(d, 3), Head(d, 1)

    def forward(self, images):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        B, D, t = images.shape[0], self.d, self.transformer
        feats = self.backbone(images.permute(0, 3, 1, 2))
        srcs = [p(f) for p, f in zip(self.input_proj, feats)]
        x = feats[-1]
        for p in self.input_proj[3:]:
            x = p(x)
            srcs.append(x)
        shapes = [tuple(s.shape[-2:]) for s in srcs]
        masks = [torch.zeros((B,) + hw, dtype=torch.bool) for hw in shapes]
        pos = torch.cat([(sine(m, D // 2) + self.level_embed[i]).reshape(B, -1, D)
                         for i, m in enumerate(masks)], 1)
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask = torch.cat([m.reshape(B, -1) for m in masks], 1)
        ratios = torch.ones(B, len(shapes), 2)          # no padding
        ref = []
        for h, w in shapes:
            ry, rx = torch.meshgrid(torch.linspace(0.5, h - 0.5, h),
                                    torch.linspace(0.5, w - 0.5, w), indexing="ij")
            ref.append(torch.stack([rx.reshape(-1) / w, ry.reshape(-1) / h], -1))
        ref = torch.cat(ref)[None, :, None].expand(B, -1, len(shapes), -1) * ratios[:, None]
        for i in range(t.enc):
            layer = getattr(t, f"encoder_layer{i}")
            src = layer.norm1(src + layer.self_attn(src + pos, ref, src, shapes, mask))
            src = layer.norm2(src + layer.linear2(F.relu(layer.linear1(src))))
        query_pos, tgt = self.query_embed[None].expand(B, -1, -1).split(D, -1)
        reference = torch.sigmoid(t.reference_points(query_pos))
        hs = []
        for i in range(t.dec):
            layer = getattr(t, f"decoder_layer{i}")
            qk = tgt + query_pos
            tgt = layer.norm1(tgt + layer.self_attn(qk, qk, tgt))
            tgt = layer.norm2(tgt + layer.cross_attn(tgt + query_pos, reference[:, :, None]
                                                     * ratios[:, None], src, shapes, mask))
            tgt = layer.norm3(tgt + layer.linear2(F.relu(layer.linear1(tgt))))
            hs.append(tgt)
        hs = torch.stack(hs)
        box = self.bbox_embed(hs)
        r = reference.clamp(0, 1)
        inv = torch.log(r.clamp(min=1e-5) / (1 - r).clamp(min=1e-5))
        box = torch.cat([box[..., :2] + inv, box[..., 2:]], -1)
        return {"pred_logits": self.class_embed(hs), "pred_boxes": box.sigmoid(),
                "pred_angle": self.angle_embed(hs), "pred_offset": self.offset_embed(hs),
                "pred_size": self.size_embed(hs), "pred_depth": self.depth_embed(hs),
                "pred_obj_features": hs}
