"""DETR transformer encoder/decoder (batch-first), post-norm or pre-norm.

Counterpart of ``odam_tpu/models/transformer.py``: separate q/k/v/out
projections around the shared attention core, positions added to queries
and keys only, LayerNorm eps 1e-6 (Flax's default), and the decoder's
per-layer intermediate stack, each normed by ``decoder_norm``.
``normalize_before`` (DETR's ``pre_norm``) norms each block's input instead
of its residual sum and adds ``encoder_norm`` after the last encoder layer.  Dropout
sits where Flax's does (three sites in an encoder layer, four in a decoder
layer) and is active only in ``.train()`` mode, with its masks drawn from
the ``generator`` passed to the forward.  ``dtype`` is the compute dtype
with Flax's semantics (:mod:`.layers`); the attention core gets q, k and v
in it.  ``use_kernels`` routes the attention core to the CUDA kernels
(JAX's ``use_pallas``); training turns it off.  ``lanes`` (the forward's
argument) is the number of scenes stacked on the batch axis, which the
attention core routes on (:func:`odam_torch.ops.attention.mha_core`), and
``shards`` the number of ranks whose blocks form the global batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha_core
from .layers import Dense, LayerNorm, dropout

LN_EPS = 1e-6


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernels = use_kernels
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def forward(self, query, key, value, key_padding_mask=None, lanes: int = 1,
                shards: int = 1):
        out = mha_core(self.q_proj(query), self.k_proj(key), self.v_proj(value),
                       self.num_heads, key_padding_mask, self.use_kernels, lanes, shards)
        return self.out_proj(out)


class _Layer(nn.Module):
    """Shared by both layer kinds: the feed-forward block and dropout."""

    def __init__(self, d_model: int, dim_feedforward: int, dropout_rate: float,
                 dtype: torch.dtype, normalize_before: bool):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.normalize_before = normalize_before
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def drop(self, x, generator):
        return dropout(x, self.dropout_rate, self.training, generator)

    def ffn(self, x, generator):
        return self.linear2(self.drop(F.relu(self.linear1(x)), generator))


class EncoderLayer(_Layer):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True, normalize_before: bool = False):
        super().__init__(d_model, dim_feedforward, dropout_rate, dtype, normalize_before)
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, use_kernels)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, LN_EPS, dtype)

    def forward(self, src, pos, key_padding_mask=None, generator=None, lanes: int = 1,
                shards: int = 1):
        if self.normalize_before:
            s2 = self.norm1(src)
            qk = s2 + pos
            src = src + self.drop(self.self_attn(qk, qk, s2, key_padding_mask, lanes, shards),
                                  generator)
            return src + self.drop(self.ffn(self.norm2(src), generator), generator)
        qk = src + pos
        src = self.norm1(src + self.drop(self.self_attn(qk, qk, src, key_padding_mask, lanes,
                                                        shards), generator))
        return self.norm2(src + self.drop(self.ffn(src, generator), generator))


class DecoderLayer(_Layer):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True, normalize_before: bool = False):
        super().__init__(d_model, dim_feedforward, dropout_rate, dtype, normalize_before)
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, use_kernels)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, dtype, use_kernels)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm3 = LayerNorm(d_model, LN_EPS, dtype)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None,
                generator=None, lanes: int = 1, shards: int = 1):
        if self.normalize_before:
            t2 = self.norm1(tgt)
            qk = t2 + query_pos
            tgt = tgt + self.drop(self.self_attn(qk, qk, t2, lanes=lanes, shards=shards),
                                  generator)
            t2 = self.norm2(tgt)
            tgt = tgt + self.drop(self.multihead_attn(
                t2 + query_pos, memory + pos, memory, memory_key_padding_mask, lanes, shards),
                generator)
            return tgt + self.drop(self.ffn(self.norm3(tgt), generator), generator)
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.drop(self.self_attn(qk, qk, tgt, lanes=lanes, shards=shards),
                                         generator))
        tgt = self.norm2(tgt + self.drop(self.multihead_attn(
            tgt + query_pos, memory + pos, memory, memory_key_padding_mask, lanes, shards),
            generator))
        return self.norm3(tgt + self.drop(self.ffn(tgt, generator), generator))


class Transformer(nn.Module):
    def __init__(self, d_model: int = 256, num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True, normalize_before: bool = False):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        args = (d_model, num_heads, dim_feedforward, dropout_rate, dtype, use_kernels,
                normalize_before)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(*args))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(*args))
        self.encoder_norm = LayerNorm(d_model, LN_EPS, dtype) if normalize_before else None
        self.decoder_norm = LayerNorm(d_model, LN_EPS, dtype)

    def forward(self, src: torch.Tensor, mask: torch.Tensor, query_embed: torch.Tensor,
                pos: torch.Tensor, generator: torch.Generator | None = None, lanes: int = 1,
                shards: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """
        Args:
            src: [B, H, W, D] projected features; mask: [B, H, W] bool
            (True = padded); query_embed: [Q, D]; pos: [B, H, W, D];
            generator: draws the dropout masks in ``.train()`` mode.
            lanes: scenes stacked on the batch axis (B / lanes images each).
            shards: ranks whose blocks of B images form the global batch.

        Returns:
            (hs [L_dec, B, Q, D] intermediate decoder states, memory [B, H, W, D]).
        """
        B, H, W, D = src.shape
        memory = src.reshape(B, H * W, D)
        pos_seq = pos.reshape(B, H * W, D)
        mask_seq = mask.reshape(B, H * W)
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_layer{i}")(memory, pos_seq, mask_seq, generator,
                                                        lanes, shards)
        if self.encoder_norm is not None:
            memory = self.encoder_norm(memory)

        query_pos = query_embed[None].expand(B, -1, -1).to(src.dtype)
        out = torch.zeros_like(query_pos)
        intermediates = []
        for i in range(self.num_decoder_layers):
            out = getattr(self, f"decoder_layer{i}")(out, memory, pos_seq, query_pos, mask_seq,
                                                     generator, lanes, shards)
            intermediates.append(self.decoder_norm(out))
        return torch.stack(intermediates, dim=0), memory.reshape(B, H, W, D)
