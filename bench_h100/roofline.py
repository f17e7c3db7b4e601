"""The yardstick's arithmetic: the H100's peaks, the model FLOPs of a frame,
and the FLOPs and bytes of each attention call.

The peaks and the bound rule are frozen copies of ``chip_smoke.py``'s
(``HBM_BYTES_PER_S``, ``PEAK_FLOPS``: the kernels run float32 as 3xTF32,
three TF32 products for each float32 one) and of
``odam_torch/scripts/bench_batched_detection.py``'s ``PEAK_TFLOPS`` (float32
outside the tensor cores at 67 TFLOP/s).  The ResNet-50 count is a copy of
that script's ``_resnet50_flops`` with two changes: the output sizes of
each convolution are exact (``(n + 2p - d(k - 1) - 1) // s + 1``), and the
last stage may be dilated instead of strided (DETR-DC5).  The transformer
count is a copy of its ``transformer_heads_flops`` with the keys' and
values' projections of the cross-attention counted over the image tokens
(the copy counted them over the queries); the heads are its estimate, on
the last decoder layer.  The associator's GNN is counted here for the first
time.  A FLOP is a multiply or an add: 2 a
multiply-add.
"""
from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32_3xtf32": 495e12 / 3, "float32": 67e12}
RESNET50_LAYERS = ((3, 64), (4, 128), (6, 256), (3, 512))   # (blocks, mid) a stage
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def conv_out(n: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def resnet50_flops(h: int, w: int, dilate_last: bool = False) -> tuple[dict, tuple[int, int]]:
    """({stem, layer1..4}: FLOPs, the stage-4 output's (h, w))."""
    stages = {}
    total = 0.0

    def conv(cin, cout, k, s, hw, d=1):
        nonlocal total
        p = d * (k // 2)
        oh, ow = conv_out(hw[0], k, s, p, d), conv_out(hw[1], k, s, p, d)
        total += 2.0 * oh * ow * cin * cout * k * k
        return (oh, ow)

    hw = conv(3, 64, 7, 2, (h, w))
    stages["stem"] = total
    hw = (conv_out(hw[0], 3, 2, 1), conv_out(hw[1], 3, 2, 1))     # max pool 3x3/2
    cin = 64
    for stage, (blocks, mid) in enumerate(RESNET50_LAYERS):
        mark = total
        dilate = dilate_last and stage == len(RESNET50_LAYERS) - 1
        for b in range(blocks):
            s = 2 if (b == 0 and stage > 0 and not dilate) else 1
            conv(cin, mid, 1, 1, hw)
            hw2 = conv(mid, mid, 3, s, hw, 2 if dilate else 1)
            conv(mid, mid * 4, 1, 1, hw2)
            if b == 0:
                conv(cin, mid * 4, 1, s, hw)
            hw = hw2
            cin = mid * 4
        stages[f"layer{stage + 1}"] = total - mark
    return stages, hw


def transformer_heads_flops(L, Q, d, ffn, enc_layers, dec_layers, heads_out=7):
    """The DETR transformer and heads at L tokens and Q queries."""
    def attn(lq, lk):
        # q and out projections over the queries, k and v over the keys
        return 2 * (2 * lq * d * d + 2 * lk * d * d) + 2 * (2 * lq * lk * d)

    def ffn_f(n):
        return 2 * (2 * n * d * ffn)

    enc = enc_layers * (attn(L, L) + ffn_f(L))
    dec = dec_layers * (attn(Q, Q) + attn(Q, L) + ffn_f(Q))
    heads = 2 * Q * d * d * 3 * heads_out
    return enc + dec + heads


def associator_flops(T: int, W: int, N: int, d: int, encoder: tuple, n_fuser: int,
                     gnn_layers: tuple) -> float:
    """One scene's associator: the keypoint encoder over T x W track rows and
    N detections, the history fuser (self-attention within each track's W
    rows), the GNN's propagation layers over T tracks and N detections
    (self or cross: each side attends to T or N keys; both sides a layer),
    the final projection and the score product.  Sinkhorn's elementwise work
    is not counted."""
    def mlp(rows, chans):
        return sum(2.0 * rows * a * b for a, b in zip(chans[:-1], chans[1:]))

    def prop(lq, lk):
        proj = 2.0 * (lq * d * d + 2 * lk * d * d + lq * d * d)       # q, k, v, merge
        attn = 4.0 * lq * lk * d
        return proj + attn + mlp(lq, (2 * d, 2 * d, d))

    f = mlp(T * W + N, encoder)
    f += n_fuser * T * prop(W, W)
    for kind in gnn_layers:
        cross = kind == "cross"
        f += prop(T, N if cross else T) + prop(N, T if cross else N)
    f += 2.0 * (T + N) * d * d + 2.0 * T * N * d
    return f


class AttentionCall(NamedTuple):
    kernel: str          # "flash" or "fused"
    B: int
    Lq: int
    Lk: int
    H: int
    dh: int
    masked: bool
    dtype: str

    def flops(self) -> float:
        """Q.K^T and P.V: 2 multiply-adds a (query, key, channel)."""
        return 4.0 * self.B * self.H * self.Lq * self.Lk * self.dh

    def bytes(self) -> float:
        """q, k, v and the output once each, and the key mask."""
        e = DTYPE_BYTES[self.dtype]
        n = self.B * self.H * self.dh * (2 * self.Lq + 2 * self.Lk) * e
        return n + (self.B * self.Lk if self.masked else 0)

    def bound_s(self) -> float:
        """The least time the chip could take: the larger of FLOPs over the
        dtype's peak and bytes over HBM bandwidth."""
        peak = PEAK_FLOPS["bfloat16" if self.dtype == "bfloat16" else "float32_3xtf32"]
        return max(self.flops() / peak, self.bytes() / HBM_BYTES_PER_S)


FLASH_MIN_KEYS = 256     # odam_torch/ops/attention.py: Lk at or above takes flash


def lane_step_attention(P: int, tokens: int, queries: int, d: int, heads: int,
                        enc_layers: int, dec_layers: int, T: int, N: int, d_gnn: int,
                        gnn_heads: int, gnn_layers: tuple, dtype: str) -> list[AttentionCall]:
    """The kernel calls of one lane step of P lanes (each lane's batch 1,
    so every call below takes a kernel): the encoder's self-attention and
    the decoder's cross-attention over the image tokens, the decoder's
    self-attention over the queries, and the GNN's calls over T track slots
    (masked) and N detection slots.  The history fuser runs at batch T a
    lane and takes the plain path."""
    def call(lq, lk, h, dh, masked):
        kind = "flash" if lk >= FLASH_MIN_KEYS else "fused"
        return AttentionCall(kind, P, lq, lk, h, dh, masked, dtype)

    calls = []
    dh = d // heads
    calls += [call(tokens, tokens, heads, dh, True) for _ in range(enc_layers)]
    for _ in range(dec_layers):
        calls += [call(queries, queries, heads, dh, False),
                  call(queries, tokens, heads, dh, True)]
    gdh = d_gnn // gnn_heads
    for kind in gnn_layers:
        if kind == "cross":
            calls += [call(T, N, gnn_heads, gdh, False), call(N, T, gnn_heads, gdh, True)]
        else:
            calls += [call(T, T, gnn_heads, gdh, True), call(N, N, gnn_heads, gdh, False)]
    return calls
