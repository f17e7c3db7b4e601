"""The yardstick's arithmetic for Deformable DETR: the model FLOPs of a frame,
and the FLOPs and bytes of each multi-scale deformable attention (MSDA) call.

Peaks and the bound rule are :mod:`.roofline`'s.  A FLOP is a multiply or
an add: 2 a multiply-add.  The count of a frame:

- the backbone: :func:`roofline.resnet50_flops` (C3, C4 and C5 are stages
  2-4 of the same network);
- the input projections: a 1x1 conv on each of C3, C4, C5 and a 3x3
  stride-2 conv on C5 for each level past those (GroupNorm not counted);
- the encoder, a layer: MSDA over every token (``value_proj`` over the
  tokens; ``sampling_offsets``, ``attention_weights`` and ``output_proj``
  over the queries; the samples) and the FFN;
- the decoder, a layer: self-attention over the queries (four projections
  and the two products), MSDA from the queries into the encoder's tokens,
  and the FFN; ``reference_points`` once;
- the heads: :func:`roofline.transformer_heads_flops`' estimate on the last
  decoder layer.

An MSDA sample (query, head, level, point) reads 4 corners of dh channels:
8 dh FLOP for the bilinear products and the weighted sum, and
``BILINEAR_FLOPS`` for its four corner weights times the attention weight.
Its least bytes (:meth:`MSDACall.bytes`) are the value, the float32
locations and weights, and the output, each once.  It runs outside the
tensor cores, so its FLOPs count against the float32 peak of 67 TFLOP/s.
"""
from __future__ import annotations

from typing import NamedTuple

from . import roofline

BILINEAR_FLOPS = 8        # the 4 corner weights (4 products) times the attention weight (4)
RESNET_CHANNELS = {2: 512, 3: 1024, 4: 2048}


class MSDACall(NamedTuple):
    B: int
    Lq: int          # queries
    Lv: int          # value tokens (every level's pixels)
    levels: int
    heads: int
    points: int
    dh: int
    dtype: str       # the value's and the output's

    def samples(self) -> int:
        return self.B * self.Lq * self.heads * self.levels * self.points

    def flops(self) -> float:
        return float(self.samples() * (8 * self.dh + BILINEAR_FLOPS))

    def bytes(self) -> float:
        e = roofline.DTYPE_BYTES[self.dtype]
        return float(self.B * self.heads * self.dh * (self.Lv + self.Lq) * e
                     + self.samples() * (2 + 1) * 4)

    def bound_s(self) -> float:
        """The larger of bytes over HBM bandwidth and FLOPs over the float32
        peak outside the tensor cores."""
        return max(self.bytes() / roofline.HBM_BYTES_PER_S,
                   self.flops() / roofline.PEAK_FLOPS["float32"])


def level_shapes(h: int, w: int, levels: int = 4) -> list[tuple[int, int]]:
    """(h, w) of each level: C3, C4, C5, then the 3x3 stride-2 convs."""
    co = roofline.conv_out
    hw = (co(co(h, 7, 2, 3), 3, 2, 1), co(co(w, 7, 2, 3), 3, 2, 1))      # stem, max pool: C2
    shapes = []
    for _ in range(3):
        hw = (co(hw[0], 3, 2, 1), co(hw[1], 3, 2, 1))
        shapes.append(hw)
    for _ in range(levels - 3):
        hw = (co(hw[0], 3, 2, 1), co(hw[1], 3, 2, 1))
        shapes.append(hw)
    return shapes


def input_proj_flops(shapes: list[tuple[int, int]], d: int) -> float:
    f = sum(2.0 * h * w * RESNET_CHANNELS[s] * d for (h, w), s in zip(shapes[:3], (2, 3, 4)))
    cin = 2048
    for h, w in shapes[3:]:
        f += 2.0 * h * w * cin * d * 9
        cin = d
    return f


def transformer_flops(tokens: int, queries: int, d: int, heads: int, levels: int,
                      enc_points: int, dec_points: int, ffn: int, enc_layers: int,
                      dec_layers: int) -> float:
    """The deformable encoder and decoder at ``tokens`` and ``queries``."""
    dh = d // heads

    def msda(lq, lv, points):
        dense = 2.0 * lv * d * d + 2.0 * lq * d * (heads * levels * points * 3 + d)
        return dense + lq * heads * levels * points * (8 * dh + BILINEAR_FLOPS)

    def ffn_f(n):
        return 4.0 * n * d * ffn

    self_attn = 8.0 * queries * d * d + 4.0 * queries * queries * d
    enc = enc_layers * (msda(tokens, tokens, enc_points) + ffn_f(tokens))
    dec = dec_layers * (self_attn + msda(queries, tokens, dec_points) + ffn_f(queries))
    return enc + dec + 2.0 * queries * d * 2


def detector_flops(h: int, w: int, model: dict) -> float:
    """The model FLOPs of one frame of ``h`` x ``w`` (a configuration's
    ``model`` keys)."""
    d, q = int(model["hidden_dim"]), int(model["num_queries"])
    stages, _ = roofline.resnet50_flops(h, w)
    shapes = level_shapes(h, w, int(model["num_feature_levels"]))
    tokens = sum(a * b for a, b in shapes)
    return (sum(stages.values()) + input_proj_flops(shapes, d)
            + transformer_flops(tokens, q, d, int(model["nheads"]), len(shapes),
                                int(model["enc_n_points"]), int(model["dec_n_points"]),
                                int(model["dim_feedforward"]), int(model["enc_layers"]),
                                int(model["dec_layers"]))
            + roofline.transformer_heads_flops(0, q, d, 0, 0, 0))


def lane_step_attention(P: int, model: dict, T: int, N: int, dtype: str
                        ) -> list[roofline.AttentionCall]:
    """The attention kernel calls of a lane step: the decoder's
    self-attention over the queries (flash at 256 keys or more), then the
    GNN's calls as :func:`roofline.lane_step_attention` counts them."""
    q, d, heads = int(model["num_queries"]), int(model["hidden_dim"]), int(model["nheads"])
    kind = "flash" if q >= roofline.FLASH_MIN_KEYS else "fused"
    calls = [roofline.AttentionCall(kind, P, q, q, heads, d // heads, False, dtype)
             for _ in range(int(model["dec_layers"]))]
    return calls + roofline.lane_step_attention(
        P, 0, 0, d, heads, 0, 0, T, N, int(model["descriptor_dim"]), 4,
        tuple(model["GNN_layers"]), dtype)


def lane_step_msda(P: int, h: int, w: int, model: dict, dtype: str) -> list[MSDACall]:
    """The MSDA calls of a lane step of P frames: one a layer, the encoder's
    over every token, the decoder's from the queries."""
    shapes = level_shapes(h, w, int(model["num_feature_levels"]))
    tokens = sum(a * b for a, b in shapes)
    d, heads, L = int(model["hidden_dim"]), int(model["nheads"]), len(shapes)
    enc = MSDACall(P, tokens, tokens, L, heads, int(model["enc_n_points"]), d // heads, dtype)
    dec = MSDACall(P, int(model["num_queries"]), tokens, L, heads, int(model["dec_n_points"]),
                   d // heads, dtype)
    return [enc] * int(model["enc_layers"]) + [dec] * int(model["dec_layers"])
