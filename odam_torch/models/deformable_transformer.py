"""Deformable DETR's transformer: multi-scale deformable attention, its
encoder and its decoder (batch-first, post-norm).

After Zhu et al., "Deformable DETR" (ICLR 2021, arXiv:2010.04159) and
fundamentalvision/Deformable-DETR's ``models/deformable_transformer.py`` and
``models/ops/modules/ms_deform_attn.py``, in its plain form (no box
refinement, not two-stage).  The JAX package has no counterpart.

- :class:`MSDeformAttn`: ``value = value_proj(x)`` (0 at padded positions),
  split into H heads; ``sampling_offsets(q)`` gives [H, L, P, 2] pixel
  offsets and ``attention_weights(q)`` a softmax over the L x P samples of a
  head; a sample sits at ``reference + offset / (w_l, h_l)``; the weighted
  sum of the bilinear samples (:func:`odam_torch.ops.msda.ms_deform_attn`)
  goes through ``output_proj``.  Locations and weights are float32 whatever
  the compute dtype (:mod:`odam_torch.ops.msda`'s precision contract).
- Encoder layer: every pixel of the L levels is a query; its reference point
  is its own centre, normalised by its level's valid extent, times each
  level's valid ratio.  ``src = LN(src + MSDA(src + pos))``, then
  ``src = LN(src + FFN(src))``.
- Decoder layer: self-attention over the queries (q = k = tgt + query_pos,
  through :func:`odam_torch.ops.attention.mha_core`, so it routes to the
  attention kernels on ``lanes``), then LN; MSDA into the encoder's memory
  at ``sigmoid(reference_points(query_pos))`` times the valid ratios, then
  LN; the FFN, then LN.  No final decoder norm.

LayerNorm eps is 1e-6, as the port's DETR transformer has it (upstream: 1e-5).
``reference_points`` computes in float32.  Dropout sits where upstream's
does and acts in ``.train()`` mode only.  The encoder and the decoder run in
the spans ``odam.detr.encoder`` and ``odam.detr.decoder``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import msda
from ..utils import metrics
from .layers import Dense, LayerNorm
from .transformer import LN_EPS, MultiHeadAttention, _Layer


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int,
                 dtype: torch.dtype = torch.float32, use_kernels: bool = True):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not divisible by {n_heads} heads")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.use_kernels = use_kernels
        self.value_proj = Dense(d_model, d_model, dtype=dtype)
        self.sampling_offsets = Dense(d_model, n_heads * n_levels * n_points * 2, dtype=dtype)
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points, dtype=dtype)
        self.output_proj = Dense(d_model, d_model, dtype=dtype)

    def forward(self, query: torch.Tensor, reference: torch.Tensor, source: torch.Tensor,
                spatial_shapes: tuple[tuple[int, int], ...], level_start: tuple[int, ...],
                sizes: torch.Tensor, padding_mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        """query [B, Lq, D]; reference [B, Lq, L, 2] float32 (x, y) in [0, 1];
        source [B, S, D]; ``sizes`` [L, 2] float32, each level's (w, h);
        padding_mask [B, S] bool, True = padded."""
        B, Lq, D = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(source)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.view(B, source.shape[1], H, D // H)
        offsets = self.sampling_offsets(query).float().view(B, Lq, H, L, P, 2)
        weights = torch.softmax(self.attention_weights(query).float().view(B, Lq, H, L * P),
                                dim=-1).view(B, Lq, H, L, P)
        locations = reference[:, :, None, :, None, :] + offsets / sizes[:, None, :]
        out = msda.ms_deform_attn(value, spatial_shapes, level_start, locations, weights,
                                  self.use_kernels)
        return self.output_proj(out.reshape(B, Lq, D))


class DeformableEncoderLayer(_Layer):
    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int, n_levels: int,
                 n_points: int, dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__(d_model, dim_feedforward, dropout_rate, dtype, False)
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype, use_kernels)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, LN_EPS, dtype)

    def forward(self, src, pos, reference, spatial_shapes, level_start, sizes,
                padding_mask=None, generator=None):
        attn = self.self_attn(src + pos, reference, src, spatial_shapes, level_start, sizes,
                              padding_mask)
        src = self.norm1(src + self.drop(attn, generator))
        return self.norm2(src + self.drop(self.ffn(src, generator), generator))


class DeformableDecoderLayer(_Layer):
    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int, n_levels: int,
                 n_points: int, dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__(d_model, dim_feedforward, dropout_rate, dtype, False)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype, use_kernels)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype, use_kernels)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm3 = LayerNorm(d_model, LN_EPS, dtype)

    def forward(self, tgt, query_pos, reference, memory, spatial_shapes, level_start, sizes,
                padding_mask=None, generator=None, lanes: int = 1, shards: int = 1):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.drop(self.self_attn(qk, qk, tgt, lanes=lanes, shards=shards),
                                         generator))
        attn = self.cross_attn(tgt + query_pos, reference, memory, spatial_shapes, level_start,
                               sizes, padding_mask)
        tgt = self.norm2(tgt + self.drop(attn, generator))
        return self.norm3(tgt + self.drop(self.ffn(tgt, generator), generator))


def valid_ratios(mask: torch.Tensor) -> torch.Tensor:
    """[B, h, w] bool (True = padded) -> [B, 2] float32, the unpadded share
    of the level's width and height (x, y)."""
    h, w = mask.shape[-2:]
    valid_h = (~mask[:, :, 0]).sum(1).float() / h
    valid_w = (~mask[:, 0, :]).sum(1).float() / w
    return torch.stack([valid_w, valid_h], dim=-1)


def encoder_reference_points(spatial_shapes: tuple[tuple[int, int], ...],
                             ratios: torch.Tensor) -> torch.Tensor:
    """Each pixel's centre over its level's valid extent, times each level's
    valid ratio: [B, S, L, 2] float32 (x, y); ``ratios`` [B, L, 2]."""
    points = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=ratios.device)
        xs = torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=ratios.device)
        ref_y, ref_x = torch.meshgrid(ys, xs, indexing="ij")
        ref_y = ref_y.reshape(-1)[None] / (ratios[:, None, lvl, 1] * h)
        ref_x = ref_x.reshape(-1)[None] / (ratios[:, None, lvl, 0] * w)
        points.append(torch.stack([ref_x, ref_y], dim=-1))
    return torch.cat(points, dim=1)[:, :, None] * ratios[:, None]


class DeformableTransformer(nn.Module):
    def __init__(self, d_model: int = 256, n_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 1024,
                 dropout_rate: float = 0.0, n_levels: int = 4, enc_n_points: int = 4,
                 dec_n_points: int = 4, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.d_model = d_model
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", DeformableEncoderLayer(
                d_model, n_heads, dim_feedforward, n_levels, enc_n_points, dropout_rate, dtype,
                use_kernels))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", DeformableDecoderLayer(
                d_model, n_heads, dim_feedforward, n_levels, dec_n_points, dropout_rate, dtype,
                use_kernels))
        self.reference_points = Dense(d_model, 2, dtype=torch.float32)
        self._sizes: dict = {}

    def level_sizes(self, spatial_shapes, device) -> torch.Tensor:
        """[L, 2] float32, each level's (w, h), on ``device``: made once a
        shape, so a step copies nothing from the host."""
        key = (spatial_shapes, str(device))
        if key not in self._sizes:
            self._sizes[key] = torch.tensor([[w, h] for h, w in spatial_shapes],
                                            dtype=torch.float32).to(device)
        return self._sizes[key]

    def forward(self, srcs: list[torch.Tensor], masks: list[torch.Tensor],
                pos: list[torch.Tensor], query_embed: torch.Tensor,
                generator: torch.Generator | None = None, lanes: int = 1, shards: int = 1
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """
        Args:
            srcs: L levels [B, h_l, w_l, D]; masks: [B, h_l, w_l] bool (True =
            padded); pos: [B, h_l, w_l, D] (the level embedding added);
            query_embed: [Q, 2D], (query_pos, tgt).
            lanes, shards: as :class:`odam_torch.models.transformer.Transformer`'s.

        Returns:
            (hs [L_dec, B, Q, D], the decoder's reference points [B, Q, 2]
            float32, before the valid ratios).
        """
        B, D = srcs[0].shape[0], self.d_model
        spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
        level_start, n = [], 0
        for h, w in spatial_shapes:
            level_start.append(n)
            n += h * w
        level_start = tuple(level_start)
        memory = torch.cat([s.reshape(B, -1, D) for s in srcs], dim=1)
        pos_seq = torch.cat([p.reshape(B, -1, D) for p in pos], dim=1)
        mask_seq = torch.cat([m.reshape(B, -1) for m in masks], dim=1)
        ratios = torch.stack([valid_ratios(m) for m in masks], dim=1)          # [B, L, 2]
        sizes = self.level_sizes(spatial_shapes, memory.device)
        with metrics.span("odam.detr.encoder"):
            reference = encoder_reference_points(spatial_shapes, ratios)
            for i in range(self.num_encoder_layers):
                memory = getattr(self, f"encoder_layer{i}")(
                    memory, pos_seq, reference, spatial_shapes, level_start, sizes, mask_seq,
                    generator)
        with metrics.span("odam.detr.decoder"):
            query_pos, tgt = torch.split(query_embed, D, dim=1)
            query_pos = query_pos[None].expand(B, -1, -1)
            reference = torch.sigmoid(self.reference_points(query_pos))        # [B, Q, 2] f32
            query_pos = query_pos.to(srcs[0].dtype)
            out = tgt[None].expand(B, -1, -1).to(srcs[0].dtype)
            ref_in = reference[:, :, None] * ratios[:, None]
            states = []
            for i in range(self.num_decoder_layers):
                out = getattr(self, f"decoder_layer{i}")(
                    out, query_pos, ref_in, memory, spatial_shapes, level_start, sizes, mask_seq,
                    generator, lanes, shards)
                states.append(out)
        return torch.stack(states), reference
