"""The FLOP and byte counters against counts taken from the reference modules
themselves at small shapes (a forward hook on every convolution and dense
layer), the dilated last stage included."""
from __future__ import annotations

import math

import pytest
import torch

from bench_h100 import roofline
from bench_h100.reference import associator as ref_assoc
from bench_h100.reference import detector as ref_det
from bench_h100.reference.layers import Conv, Dense


def _hooked_flops(module: torch.nn.Module, run) -> float:
    """2 x the multiply-adds of every Conv and Dense that ``run`` calls."""
    total = [0.0]

    def conv_hook(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_channels * m.kernel_size[0] \
            * m.kernel_size[1] / m.groups

    def dense_hook(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv) else dense_hook)
             for m in module.modules() if isinstance(m, (Conv, Dense))]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


@pytest.mark.parametrize("dilate", [False, True])
@pytest.mark.parametrize("hw", [(64, 96), (65, 99)])
def test_resnet50_count_equals_the_convolutions_run(dilate, hw):
    net = ref_det.ResNet50(dilate).eval()
    x = torch.zeros(1, 3, *hw)
    stages, out_hw = roofline.resnet50_flops(*hw, dilate)
    assert _hooked_flops(net, lambda: net(x)) == sum(stages.values())
    assert tuple(net(x).shape[-2:]) == out_hw


def test_dilated_last_stage_gives_four_times_the_tokens():
    _, hw = roofline.resnet50_flops(800, 1071, False)
    _, hw5 = roofline.resnet50_flops(800, 1071, True)
    assert hw == (25, 34) and hw5 == (50, 67)
    plain, dc5 = roofline.resnet50_flops(800, 1071)[0], roofline.resnet50_flops(
        800, 1071, True)[0]
    # every conv of the stage but the first block's 1x1 reduce runs on 4x the pixels
    assert 3 * plain["layer4"] < dc5["layer4"] < 4 * plain["layer4"]
    assert dc5["layer3"] == plain["layer3"]


def test_attention_call_by_hand():
    c = roofline.AttentionCall("flash", B=2, Lq=3, Lk=5, H=4, dh=8, masked=True,
                               dtype="bfloat16")
    assert c.flops() == 2 * (2 * 2 * 4 * 3 * 5 * 8)       # Q.K^T and P.V
    assert c.bytes() == 2 * 2 * 4 * 8 * (3 + 5 + 5 + 3) + 2 * 5
    assert c.bound_s() == max(c.flops() / 989e12, c.bytes() / 3.35e12)
    f32 = c._replace(dtype="float32", masked=False)
    assert f32.bytes() == 4 * 2 * 4 * 8 * 16
    assert f32.bound_s() == max(f32.flops() / (495e12 / 3), f32.bytes() / 3.35e12)


def test_lane_step_calls_match_the_routing():
    calls = roofline.lane_step_attention(16, 850, 100, 256, 8, 6, 6, 64, 30, 256, 4,
                                         ("self", "cross") * 4, "bfloat16")
    flash = [c for c in calls if c.kernel == "flash"]
    fused = [c for c in calls if c.kernel == "fused"]
    assert len(flash) == 12 and len(fused) == 22       # chip_smoke's launch counts a step
    assert {(c.Lq, c.Lk) for c in flash} == {(850, 850), (100, 850)}
    assert all(c.B == 16 for c in calls)


def test_transformer_and_associator_counts_equal_the_layers_run():
    cfg = ref_det.DetectorConfig(hidden_dim=32, nheads=4, enc_layers=2, dec_layers=2,
                                 dim_feedforward=64, num_queries=5)
    tr = ref_det.Transformer(cfg).eval()
    L = 6
    src, pos = torch.zeros(1, 2, 3, 32), torch.zeros(1, 2, 3, 32)
    mask = torch.zeros(1, 2, 3, dtype=torch.bool)
    query = torch.zeros(5, 32)
    dense = _hooked_flops(tr, lambda: tr(src, mask, query, pos))
    attn_products = 2 * (2 * 2 * L * L * 32) + 2 * (2 * 2 * 5 * 5 * 32 + 2 * 2 * 5 * L * 32)
    heads = 2 * 5 * 32 * 32 * 3 * 7
    assert roofline.transformer_heads_flops(L, 5, 32, 64, 2, 2) == dense + attn_products + heads

    ac = ref_assoc.AssociatorConfig(descriptor_dim=16, keypoint_encoder=(78, 16, 16),
                                    gnn_layers=("self", "cross"), self_gnn_layers=("self",),
                                    sinkhorn_iterations=2)
    model = ref_assoc.Associator(ac).eval()
    T, W, N = 3, 4, 2
    tracks, dets = torch.zeros(1, T, W, 79), torch.zeros(1, N, 79)
    tm, dm = torch.ones(1, T, dtype=torch.bool), torch.ones(1, N, dtype=torch.bool)
    dense = _hooked_flops(model, lambda: model(tracks, tm, dets, dm, 0.1))
    products = 4 * 16 * (T * W * W + T * T + N * N + T * N + N * T) + 2 * T * N * 16
    counted = roofline.associator_flops(T, W, N, 16, (78, 16, 16), 1, ("self", "cross"))
    assert counted == dense + products
    assert math.isfinite(dense) and dense > 0
