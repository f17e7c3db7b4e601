"""The ``odam_deformable_r50.lanes16`` cell: Deformable DETR through the lanes.

On the CPU at tiny sizes (frames 96x128, 2 lanes; the model at its
published widths and depths): a run of the cell reads ``correct``; three
faults planted in the program's multi-scale deformable attention (a level
dropped, the points cut from 4 to 1, x and y swapped in the locations)
each come out not correct; the control (fp8 operands) does too; a program
without the deformable detector fails at set-up, before any weight is drawn.
Also: the cell's limits cover what its check compares, the FLOP counter
against the reference's own layers, and the reference's imports.  On the
card (``-m h100``): a short run is correct, Sinkhorn cut short is caught
by ``z_norm``, and the fp8 control and the bf16-location control are read
beside the limits.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench_h100 import calibrate, manifest, roofline, roofline_deformable, run
from bench_h100.conftest import TINY_TRAFFIC
from bench_h100.reference import deformable as ref_def
from bench_h100.reference.layers import Conv, Dense

CELL = "odam_deformable_r50.lanes16"
TRAFFIC = "lanes16_deformable"
PKG = Path(__file__).resolve().parents[1]
SECONDS = 4.0          # a tiny step takes ~1 s on the CPU: the check keeps a step


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deformable_root(tiny_root):
    """The tiny root with this cell's traffic cut as the lanes' is."""
    p = tiny_root / "pkg" / "traffic" / f"{TRAFFIC}.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **TINY_TRAFFIC["lanes16"]}))
    return tiny_root


def _run(root, trace=False, seed=2 ** 31 + 11):
    return run.run_cell(CELL, seed, SECONDS, trace, torch.device("cpu"), root=root,
                        pkg=root / "pkg")


def test_a_tiny_run_of_the_cell_is_correct(deformable_root):
    out = _run(deformable_root, trace=True)
    assert out["correct"], out["compared"]
    assert out["compared"]["lane_steps"]["value"] >= 1 and out["attempted"] >= 2
    # the host span is read on the CPU; the device metrics need the card
    assert out["metrics"]["msda_host_ms_per_step"]["value"] > 0
    assert "msda_device_ms_per_step" not in out["metrics"]


def _plant(monkeypatch, fault):
    from odam_torch.ops import msda

    real = msda.ms_deform_attn

    def planted(value, shapes, starts, locations, weights, use_kernels=True):
        if fault == "level":
            weights = torch.cat([weights[:, :, :, :-1], 0 * weights[:, :, :, -1:]], dim=3)
        elif fault == "points":
            weights = torch.cat([weights[..., :1], 0 * weights[..., 1:]], dim=-1)
            weights = weights / weights.sum((-1, -2), keepdim=True)
        else:
            locations = locations.flip(-1)
        return real(value, shapes, starts, locations, weights, use_kernels)

    monkeypatch.setattr(msda, "ms_deform_attn", planted)


@pytest.mark.parametrize("fault", ["level", "points", "xy"])
def test_a_fault_in_the_deformable_attention_is_not_correct(deformable_root, monkeypatch,
                                                            fault):
    _plant(monkeypatch, fault)
    out = _run(deformable_root)
    compared = out["compared"]
    assert compared["lane_steps"]["holds"], compared
    assert not out["correct"] and not compared["state_gap"]["holds"], compared


def test_the_control_is_not_correct_at_tiny_size(deformable_root):
    (reading,) = calibrate.readings(CELL, [], [11], SECONDS, torch.device("cpu"),
                                    root=deformable_root, pkg=deformable_root / "pkg")
    correct, compared = run.evaluate(reading["numbers"],
                                     manifest.limits(CELL, deformable_root / "pkg"))
    assert reading["of"] == "control" and reading["numbers"]["lane_steps"] >= 1
    assert not correct, compared


def test_a_program_without_the_deformable_detector_fails_at_set_up(deformable_root,
                                                                   monkeypatch):
    """As the parent commit would: the factory missing, or a factory that
    builds a detector without deformable attention, raises in set-up, before
    the weights are drawn."""
    from odam_torch.models import detr as detr_mod

    from bench_h100 import weights

    drawn = []
    monkeypatch.setattr(weights, "seeded_state",
                        lambda *a, **k: drawn.append(1) or pytest.fail("weights drawn"))
    monkeypatch.delattr(detr_mod, "detector_from_cfg")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no detector factory"):
        _run(deformable_root)
    monkeypatch.setattr(detr_mod, "detector_from_cfg",
                        lambda cfg, dtype=torch.float32, use_kernels=True: detr_mod.DETR(
                            detr_mod.DETRConfig.from_cfg({**cfg, "transformer": "detr"},
                                                         dtype=dtype)), raising=False)
    with pytest.raises(RuntimeError, match="no multi-scale deformable attention"):
        _run(deformable_root)
    assert not drawn and time.perf_counter() - t0 < 60


def test_the_cells_limits_cover_what_its_check_compares():
    limits = manifest.limits(CELL)
    assert manifest.traffic(TRAFFIC)["mix"] == "lanes_deformable"
    assert set(limits["max"]) == {"state_gap", "track_gap", "z_norm", "row_gap", "store_gap"}
    assert limits["min"] == {"lane_steps": 1} and all(v > 0 for v in limits["max"].values())
    lanes16 = manifest.traffic("lanes16")
    assert {**manifest.traffic(TRAFFIC), "mix": "lanes"} == lanes16


def _hooked_flops(module, fn) -> float:
    total = [0.0]

    def hook(m, inp, out):
        if isinstance(m, Conv):
            total[0] += 2.0 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        else:
            total[0] += 2.0 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (Conv, Dense))]
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def test_the_flop_count_equals_the_reference_layers_run():
    """At 65x99 with 2 + 2 layers of width 64: the input projections and the
    transformer's dense layers as hooked on the reference, plus the
    attention products and the MSDA samples the count adds by hand."""
    c = ref_def.DeformableConfig(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
                                 dim_feedforward=96, num_queries=7)
    model = ref_def.DeformableDETR(c).eval()
    images = torch.zeros(1, 65, 99, 3)
    shapes = roofline_deformable.level_shapes(65, 99)
    with torch.no_grad():
        feats = model.features(images.permute(0, 3, 1, 2))
    assert [tuple(f.shape[-2:]) for f in feats] == shapes[:3]
    proj = _hooked_flops(model.input_proj, lambda: model(images))
    assert proj == roofline_deformable.input_proj_flops(shapes, 64)
    tokens, Q, L, P, dh = sum(h * w for h, w in shapes), 7, 4, 4, 16
    dense = _hooked_flops(model.transformer, lambda: model(images))
    products = 2 * (4 * Q * Q * 64) + 2 * (tokens + Q) * 4 * L * P * (8 * dh + 8)
    counted = roofline_deformable.transformer_flops(tokens, Q, 64, 4, L, P, P, 96, 2, 2)
    assert counted == pytest.approx(dense + products, rel=1e-12)
    assert roofline_deformable.level_shapes(800, 1071) == [(100, 134), (50, 67), (25, 34),
                                                           (13, 17)]


def test_an_msda_call_by_hand():
    c = roofline_deformable.MSDACall(B=2, Lq=3, Lv=5, levels=4, heads=8, points=4, dh=32,
                                     dtype="bfloat16")
    samples = 2 * 3 * 8 * 4 * 4
    assert c.flops() == samples * (8 * 32 + 8)
    assert c.bytes() == 2 * 8 * 32 * (5 + 3) * 2 + samples * 12
    assert c.bound_s() == max(c.bytes() / 3.35e12, c.flops() / 67e12)
    calls = roofline_deformable.lane_step_msda(16, 800, 1071, manifest.config(
        manifest.load(), "odam_deformable_r50")["model"], "bfloat16")
    assert [(x.Lq, x.Lv) for x in calls] == [(17821, 17821)] * 6 + [(300, 17821)] * 6
    assert 1.0e-3 < sum(x.bound_s() for x in calls) < 2.0e-3     # ~1.3 ms of least bytes
    assert roofline.PEAK_FLOPS["float32"] == 67e12


def test_the_deformable_reference_imports_nothing_of_the_program():
    names = set()
    for node in ast.walk(ast.parse((PKG / "reference" / "deformable.py").read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"odam_torch", "odam_tpu", "jax", "jaxlib", "flax", "bench_h100"}
    code = ("import sys; sys.path.insert(0, %r); import bench_h100.reference.deformable; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('odam_torch', 'odam_tpu', 'jax', 'jaxlib', 'flax')))" % str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr[-2000:]


# ---------------------------------------------------------------- the card

@pytest.mark.h100
def test_a_short_run_on_the_card_is_correct(card):
    out = run.run_cell(CELL, 2 ** 31 + 17, 3.0, False, card)
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu" and run.forbidden_modules() == []


@pytest.mark.h100
def test_sinkhorn_cut_short_on_the_card_is_not_correct(card, monkeypatch):
    """At the cell's size, Sinkhorn cut from 100 iterations to 3 fails by
    ``z_norm``, which this cell compares in ``z_median``'s place; the store
    and the ids stay within their limits (PERF.md §2)."""
    from odam_torch.ops import sinkhorn

    real = sinkhorn.log_optimal_transport
    monkeypatch.setattr(sinkhorn, "log_optimal_transport",
                        lambda scores, alpha, iters=100, **kw: real(scores, alpha, iters=3, **kw))
    out = run.run_cell(CELL, 2 ** 31 + 19, 3.0, False, card)
    compared = out["compared"]
    assert "z_median" not in compared and compared["lane_steps"]["holds"], compared
    assert not out["correct"] and not compared["z_norm"]["holds"], compared


@pytest.mark.h100
def test_the_controls_read_beside_the_limits_on_the_card(card):
    """The fp8 control is not correct on three seeds; the bf16-location
    control is read and printed beside the limits (it is a reading, not a
    bar: rounding the locations is not a precision the configuration
    states)."""
    from bench_h100.mixes import lanes_deformable

    limits = manifest.limits(CELL)
    for reading in calibrate.readings(CELL, [], [101, 102, 103], 3.0, card):
        correct, compared = run.evaluate(reading["numbers"], limits)
        assert not correct, (reading["seed"], compared)
    bench = manifest.load()
    w = manifest.cell(bench, CELL)
    mix = lanes_deformable.Mix(manifest.config(bench, w["config"]),
                               manifest.traffic(w["traffic"]), 104, card)
    mix.setup()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        mix.unit((time.perf_counter() - t0) / 3.0)
    mix.release()
    numbers = mix.location_control_check()
    correct, compared = run.evaluate(numbers, limits)
    print(json.dumps({"bf16_location_control": compared, "correct": correct}))
    assert numbers["lane_steps"] >= 1
