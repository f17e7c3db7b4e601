"""DETR transformer encoder/decoder (post-norm, batch-first).

Counterpart of ``odam_tpu/models/transformer.py``: separate q/k/v/out
projections around the shared attention core, positions added to queries
and keys only, LayerNorm eps 1e-6 (Flax's default), and the decoder's
per-layer intermediate stack, each normed by ``decoder_norm``.  Inference
only: dropout is off, so it is left out.  ``dtype`` is the compute dtype
with Flax's semantics (:mod:`.layers`); the attention core gets q, k and v
in it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha_core
from .layers import Dense, LayerNorm

LN_EPS = 1e-6


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def forward(self, query, key, value, key_padding_mask=None):
        out = mha_core(self.q_proj(query), self.k_proj(key), self.v_proj(value),
                       self.num_heads, key_padding_mask)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, LN_EPS, dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def forward(self, src, pos, key_padding_mask=None):
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src, key_padding_mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, dtype)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm3 = LayerNorm(d_model, LN_EPS, dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(
            tgt + query_pos, memory + pos, memory, memory_key_padding_mask))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Transformer(nn.Module):
    def __init__(self, d_model: int = 256, num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}",
                            EncoderLayer(d_model, num_heads, dim_feedforward, dtype))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}",
                            DecoderLayer(d_model, num_heads, dim_feedforward, dtype))
        self.decoder_norm = LayerNorm(d_model, LN_EPS, dtype)

    def forward(self, src: torch.Tensor, mask: torch.Tensor, query_embed: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """
        Args:
            src: [B, H, W, D] projected features; mask: [B, H, W] bool
            (True = padded); query_embed: [Q, D]; pos: [B, H, W, D].

        Returns:
            (hs [L_dec, B, Q, D] intermediate decoder states, memory [B, H, W, D]).
        """
        B, H, W, D = src.shape
        memory = src.reshape(B, H * W, D)
        pos_seq = pos.reshape(B, H * W, D)
        mask_seq = mask.reshape(B, H * W)
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_layer{i}")(memory, pos_seq, mask_seq)

        query_pos = query_embed[None].expand(B, -1, -1).to(src.dtype)
        out = torch.zeros_like(query_pos)
        intermediates = []
        for i in range(self.num_decoder_layers):
            out = getattr(self, f"decoder_layer{i}")(out, memory, pos_seq, query_pos, mask_seq)
            intermediates.append(self.decoder_norm(out))
        return torch.stack(intermediates, dim=0), memory.reshape(B, H, W, D)
