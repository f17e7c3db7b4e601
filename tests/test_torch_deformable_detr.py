"""Deformable DETR in the port (``odam_torch/models/deformable_detr.py``,
``deformable_transformer.py``, ``ops/msda.py``) against the plain float32
reference of ``tests/plain_deformable_detr.py`` and a literal per-sample
loop, on seeded weights, on the CPU; its factory, its entry points
(``SceneParallelRunner.step``, ``OdamPipeline``, ``run_processor``) and its
spans and counters.  One ``h100`` test holds the MSDA kernel to the plain
route on the card; it skips without one.  On a machine with a card and
without JAX (which ``tests/conftest.py`` imports)::

    python3 -m pytest tests/test_torch_deformable_detr.py --noconftest -p no:cacheprovider

Each tolerance is given with its reason.
"""
from __future__ import annotations

import functools
import math
import os
import pickle

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from odam_torch import config as t_config
from odam_torch.models import associator as t_assoc
from odam_torch.models import deformable_detr as t_dd
from odam_torch.models import detr as t_detr
from odam_torch.ops import kernels, msda
from odam_torch.runtime import processor as t_proc
from odam_torch.runtime import scene_parallel as t_sp
from odam_torch.runtime import tracker as t_trk
from odam_torch.utils import metrics
from plain_deformable_detr import PlainDeformableDETR
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAML = os.path.join(ROOT, "odam_torch", "configs", "deformable_detr_scan_net.yaml")
HARD = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard")
# the benchmark cell's levels at 800x1071: C3, C4, C5 and the stride-2 conv on C5
CELL_LEVELS = ((100, 134), (50, 67), (25, 34), (13, 17))
TINY = dict(transformer="deformable", num_classes=8, num_queries=8, hidden_dim=64, nheads=4,
            enc_layers=1, dec_layers=1, dim_feedforward=32, aux_loss=False, backbone="tiny")
PIPE = dict(detect_threshold=0.0, score_threshold=0.0, max_tracks=8, max_dets=5, window=6,
            track_bbox_samples=64, max_log_frames=16, max_objs=8, max_views=8, min_views=2,
            optim_iters=5, optim_samples=64)


def _inputs(levels, B=2, Lq=7, H=2, dh=8, P=3, seed=0, dtype=torch.float32):
    """Seeded MSDA inputs with samples off the map, on its border and at
    pixel centres, and a padded row at the end of each level."""
    g = torch.Generator().manual_seed(seed)
    S = sum(h * w for h, w in levels)
    L = len(levels)
    value = torch.randn(B, S, H, dh, generator=g)
    loc = torch.rand(B, Lq, H, L, P, 2, generator=g) * 1.4 - 0.2       # 1 in ~7 off the map
    loc[0, 0, 0, :, 0] = 0.0                                            # the map's corner
    loc[0, 1, 0, :, 0] = torch.tensor([1.0, 0.5])                       # its right border
    for lvl, (h, w) in enumerate(levels):
        loc[1, 0, 1, lvl, 0] = torch.tensor([(w - 0.5) / w, (h - 0.5) / h])   # last centre
        loc[1, 1, 1, lvl, 0] = torch.tensor([-0.5 / w, 0.5])            # half a pixel outside
    weights = torch.softmax(torch.randn(B, Lq, H, L * P, generator=g), -1).view(B, Lq, H, L, P)
    starts, n = [], 0
    for h, w in levels:
        starts.append(n)
        n += h * w
    return value.to(dtype), tuple(levels), tuple(starts), loc, weights


def _literal(value, levels, starts, loc, weights, padded=None):
    """One sample at a time: pixel (x w - 0.5, y h - 0.5), four corners, a
    corner off the map (or padded) read as 0, in float64."""
    B, _, H, dh = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    v = value.double()
    if padded is not None:
        v = v.masked_fill(padded[:, :, None, None], 0.0)
    out = torch.zeros(B, Lq, H, dh, dtype=torch.float64)
    for b in range(B):
        for q in range(Lq):
            for h in range(H):
                for lvl in range(L):
                    hh, ww = levels[lvl]
                    for p in range(P):
                        x = float(loc[b, q, h, lvl, p, 0]) * ww - 0.5
                        y = float(loc[b, q, h, lvl, p, 1]) * hh - 0.5
                        x0, y0 = math.floor(x), math.floor(y)
                        for yy, xx, wgt in ((y0, x0, (y0 + 1 - y) * (x0 + 1 - x)),
                                            (y0, x0 + 1, (y0 + 1 - y) * (x - x0)),
                                            (y0 + 1, x0, (y - y0) * (x0 + 1 - x)),
                                            (y0 + 1, x0 + 1, (y - y0) * (x - x0))):
                            if 0 <= yy < hh and 0 <= xx < ww:
                                out[b, q, h] += (float(weights[b, q, h, lvl, p]) * wgt
                                                 * v[b, starts[lvl] + yy * ww + xx, h])
    return out


@pytest.mark.parametrize("levels,use_kernels", [(((5, 7), (3, 4), (2, 3)), True),
                                                (((5, 7), (3, 4), (2, 3)), False),
                                                (((1, 1), (4, 9)), True)])
def test_msda_matches_a_literal_loop(levels, use_kernels):
    """Off the map, on its border, at odd sizes and with padded rows set to 0
    (as the model's ``value_proj`` output is): within 1e-5 of the largest
    output, float32 sums against float64 (grid_sample's ((2 loc - 1) + 1) w
    - 1) / 2 rounds the pixel differently from loc w - 0.5 by ~1e-7)."""
    value, shapes, starts, loc, weights = _inputs(levels)
    padded = torch.zeros(value.shape[:2], dtype=torch.bool)
    padded[:, starts[-1]:starts[-1] + shapes[-1][1]] = True             # a row of the last level
    value = value.masked_fill(padded[:, :, None, None], 0.0)
    before = {key: kernels.counts(key)["ms_deform_attn"]
              for key in ("LAUNCHES", "PLAIN_CALLS", "SAMPLES")}
    got = msda.ms_deform_attn(value, shapes, starts, loc, weights, use_kernels)
    want = _literal(value, shapes, starts, loc, weights, padded)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert kernels.counts("PLAIN_CALLS")["ms_deform_attn"] == before["PLAIN_CALLS"] + 1
    assert kernels.counts("LAUNCHES")["ms_deform_attn"] == before["LAUNCHES"]
    assert kernels.counts("SAMPLES")["ms_deform_attn"] == before["SAMPLES"] + weights.numel()


def test_msda_bf16_value_rounds_once_and_refuses_what_it_cannot_take():
    """A bfloat16 value: the float32 sum rounded once to bfloat16 (equal to
    the float32 result of the same bf16 values, rounded).  The kernel route
    raises under grad on an input that requires grad; the plain route
    (``use_kernels=False``) carries the gradient.  Bad shapes raise."""
    value, shapes, starts, loc, weights = _inputs(((5, 7), (3, 4)), dtype=torch.bfloat16)
    got = msda.ms_deform_attn(value, shapes, starts, loc, weights)
    want = msda.ms_deform_attn(value.float(), shapes, starts, loc, weights).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    v = value.float().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        msda.ms_deform_attn(v, shapes, starts, loc, weights)
    msda.ms_deform_attn(v, shapes, starts, loc, weights, use_kernels=False).sum().backward()
    assert v.grad is not None and float(v.grad.abs().sum()) > 0
    with pytest.raises(ValueError, match="tile"):
        msda.ms_deform_attn(value, shapes, (0, 30), loc, weights)
    with pytest.raises(ValueError, match="float32"):
        msda.ms_deform_attn(value, shapes, starts, loc.to(torch.bfloat16), weights)


def _load_same(model, seed=0):
    """The port's seeded weights, with Deformable DETR's sampling grid in the
    offsets' biases and small random biases elsewhere (so no term of the
    comparison is zero); the state dict both models load."""
    t_detr.init_detector(model, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    sd = model.state_dict()
    for k, t in sd.items():
        if k.endswith(".bias") and ".bn" not in k and "downsample_bn" not in k:
            sd[k] = t + 0.05 * torch.randn(t.shape, generator=g)
        if k.endswith("sampling_offsets.bias"):
            H, L, P = 8, model.config.num_feature_levels, 4
            theta = torch.arange(H) * (2 * math.pi / H)
            grid = torch.stack([theta.cos(), theta.sin()], -1)
            grid = grid / grid.abs().max(-1, keepdim=True)[0]
            sd[k] = (grid[:, None, None] * torch.arange(1, P + 1.0)[None, None, :, None]
                     ).expand(H, L, P, 2).reshape(-1).clone()
    model.load_state_dict(sd)
    return sd


@pytest.fixture(scope="module")
def full_width():
    """The published widths (256, 8 heads, 4 levels x 4 points, FFN 1024, 300
    queries) at 1 + 1 layers, and the plain reference with the same weights."""
    cfg = t_config.merge_cfg([YAML])
    cfg.update(enc_layers=1, dec_layers=1)
    model = t_detr.detector_from_cfg(cfg)
    sd = _load_same(model)
    ref = PlainDeformableDETR(enc=1, dec=1)
    ref.load_state_dict(sd, strict=True)
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = ref(images)
    return cfg, sd, images, want


def test_full_width_detector_matches_the_plain_reference(full_width):
    """float32: every head within 2e-5 of its largest value (summation order:
    oneDNN convolutions and GroupNorm against the reference's; observed
    ~1e-6).  bfloat16 (the cell's dtype): the decoder state within 0.03 in
    ||a - b|| / ||b|| (about a dozen bf16 roundings along the path, ~0.01
    observed), boxes within 0.01 of the frame."""
    cfg, sd, images, want = full_width
    model = t_detr.detector_from_cfg(cfg).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(images)
    assert isinstance(model, t_dd.DeformableDETR) and got["pred_logits"].shape == (2, 300, 19)
    for k, w in want.items():
        w = w[-1]
        assert float((got[k] - w).abs().max()) <= 2e-5 * float(w.abs().max()), k
    bf = t_detr.detector_from_cfg(cfg, dtype=torch.bfloat16).eval()
    bf.load_state_dict(sd)
    with torch.no_grad():
        low = bf(images)
    a, b = low["pred_obj_features"].float(), want["pred_obj_features"][-1]
    assert float((a - b).norm() / b.norm()) <= 0.03
    assert float((low["pred_boxes"].float() - want["pred_boxes"][-1]).abs().max()) <= 0.01


def test_factory_builds_detr_unless_the_yaml_says_deformable():
    """Without ``transformer: deformable`` the factory builds exactly the DETR
    that ``DETRConfig.from_cfg`` gives (same state dict, same output); with
    it, Deformable DETR with main.py's names read; box refinement and two-stage
    raise."""
    detr_yaml = t_config.merge_cfg([os.path.join(ROOT, "configs", "detr_scan_net.yaml")])
    small = dict(enc_layers=1, dec_layers=1, backbone="tiny", backbone_stage=3)
    a = t_detr.init_detector(t_detr.detector_from_cfg({**detr_yaml, **small}), device="cpu")
    b = t_detr.build_detr(t_detr.DETRConfig.from_cfg({**detr_yaml, **small}), device="cpu")
    assert type(a) is t_detr.DETR and a.config == b.config
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    x = torch.randn(1, 64, 64, 3)
    with torch.no_grad():
        assert torch.equal(a(x)["pred_boxes"], b(x)["pred_boxes"])
    c = t_dd.DeformableDETRConfig.from_cfg(t_config.merge_cfg([YAML]))
    assert (c.num_queries, c.dim_feedforward, c.num_feature_levels, c.enc_n_points,
            c.dec_n_points, c.hidden_dim, c.nheads) == (300, 1024, 4, 4, 4, 256, 8)
    for key in ("with_box_refine", "two_stage"):
        with pytest.raises(NotImplementedError, match=key):
            t_detr.detector_from_cfg({**TINY, key: True})
    with pytest.raises(ValueError, match="unknown transformer"):
        t_detr.detector_from_cfg({"transformer": "swin"})
    with pytest.raises(ValueError, match="builds DETR only"):
        t_detr.DETRConfig.from_cfg(t_config.merge_cfg([YAML]))


@pytest.mark.parametrize("script,argv", [
    ("train_detector", ["--synthetic", "--steps", "1", "--dtype", "float32"]),
    ("bench_batched_detection", ["--dtype", "float32", "--batches", "1", "--iters", "1"]),
])
def test_entry_points_that_run_detr_only_refuse_the_deformable_yaml(script, argv, tmp_path):
    """The DETR training step (its Flax checkpoints) and the batched-detection
    bench (DETR's FLOP count) build DETR alone: given the deformable YAML
    they raise before building a model, and do not run DETR in its place."""
    import importlib

    main = importlib.import_module(f"odam_torch.scripts.{script}").main
    with pytest.raises(ValueError, match="builds DETR only"):
        main(["--config_path", YAML, "--device", "cpu", *argv]
             + (["--out_dir", str(tmp_path)] if script == "train_detector" else []))


def _tiny(seed=0, **kw):
    model = t_detr.init_detector(t_detr.detector_from_cfg({**TINY, **kw}), seed=seed,
                                 device="cpu")
    return model


def test_lanes_of_two_equal_two_single_lane_calls():
    """A tiny Deformable DETR (TinyBackbone, hidden 64, 4 levels) on two
    96x96 frames at ``lanes=2`` against each frame alone: every head within
    1e-5 (oneDNN's batched against unbatched convolutions, ~2e-6 observed;
    at 64x64 the 1x1 level's GroupNorm over 2 values a group amplifies them
    to ~5e-5); the self-attention routes to the kernel wrapper both ways
    (B / lanes = 1)."""
    model = _tiny(aux_loss=True, dec_layers=2)
    x = torch.randn(2, 96, 96, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        both = model(x, lanes=2)
        one = [model(x[i:i + 1]) for i in range(2)]
    assert len(both["aux_outputs"]) == 1
    for k in ("pred_logits", "pred_boxes", "pred_obj_features"):
        single = torch.cat([o[k] for o in one])
        assert float((both[k] - single).abs().max()) <= 1e-5, k


def _scenes(n_frames=3):
    rng = np.random.default_rng(5)
    K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)
    scenes = []
    for s in range(2):
        poses = []
        for f in range(n_frames):
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = [0.05 * f, 0.02 * s, -2.0]
            poses.append(T)
        scenes.append({"frames": [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                                  for _ in range(n_frames)],
                       "frame_ids": [10 * s + f for f in range(n_frames)], "T_wcs": poses,
                       "K": K})
    return scenes


def test_scene_parallel_steps_equal_the_serial_pipeline():
    """``SceneParallelRunner`` on 2 lanes of 3 frames with a tiny Deformable
    DETR (thresholds 0, so every step detects and associates) against the
    serial ``OdamPipeline`` scene by scene: stores with their integer fields
    exact and float fields within 1e-3 (the lanes run the detector at B = 2,
    the pipeline at B = 1), logged ids exact, rows within 1e-3."""
    model = _tiny()
    assoc = t_assoc.build_associator(t_assoc.AssociatorConfig(
        descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
        self_gnn_layers=("self",), sinkhorn_iterations=20), seed=1, device="cpu")
    cfg = t_proc.PipelineConfig(**PIPE)
    scenes = _scenes()
    runner = t_sp.SceneParallelRunner(model, assoc, cfg, 2, device="cpu")
    stores, logs = runner.run_frames(scenes, 64.0, 64.0)
    assert logs.count.tolist() == [3, 3] and int(stores.count.min()) > 0
    pipe = t_proc.OdamPipeline(model, assoc, cfg, device="cpu")
    for lane, s in enumerate(scenes):
        pipe.init_sequence(s["K"], 64, 64)
        for img, fid, T_wc in zip(s["frames"], s["frame_ids"], s["T_wcs"]):
            pipe.process_frame(img, fid, T_wc)
        for name, x, y in zip(t_trk.TrackStore._fields, t_trk.lane_of(stores, lane),
                              pipe.sequence["store"]):
            if x.dtype.is_floating_point:
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-3, err_msg=name)
            else:
                assert torch.equal(x, y), (lane, name)
        got = t_trk.drain_log(t_trk.lane_of(logs, lane))
        want = t_trk.drain_log(pipe.sequence["log"])
        assert list(got) == list(want) and want
        for tid in want:
            np.testing.assert_array_equal(got[tid][:, :2], want[tid][:, :2])
            np.testing.assert_allclose(got[tid], want[tid], atol=1e-3)


def test_run_processor_runs_the_deformable_yaml(tmp_path, monkeypatch, capsys):
    """``run_processor --config_path odam_torch/configs/deformable_detr_scan_net.yaml``
    on one committed hard scene (2 frames at 128 px, seeded full-width
    weights, float32, 5 Adam iterations) runs to its pickle, through the
    deformable detector (12 MSDA calls a frame)."""
    from odam_torch.scripts import run_processor as t_run

    monkeypatch.setattr(t_proc, "PipelineConfig", functools.partial(
        t_proc.PipelineConfig, optim_iters=5, optim_samples=64))
    split = tmp_path / "split.txt"
    split.write_text("scene9700_00\n")
    calls = kernels.counts("PLAIN_CALLS")["ms_deform_attn"]
    assert t_run.main(["--config_path", YAML, "--scans_root", os.path.join(HARD, "scans"),
                       "--sequences", str(split), "--short_side", "128", "--max_size", "128",
                       "--max_frames", "2", "--max_objs", "8", "--max_views", "8",
                       "--min_views", "2", "--dtype", "float32", "--device", "cpu",
                       "--out_dir", str(tmp_path / "out")]) == 0
    assert kernels.counts("PLAIN_CALLS")["ms_deform_attn"] - calls == 2 * 12
    with open(tmp_path / "out" / "scene9700_00" / "scene9700_00", "rb") as f:
        out = pickle.load(f)
    assert set(out) == {"tracks", "bboxes_qc", "bboxes_dl", "quadrics"}
    assert "scene9700_00" in capsys.readouterr().out


# ---------------------------------------------------------------- tracing

def test_a_lane_step_traces_twelve_msda_spans_inside_the_detector():
    """Profiled, one lane step of a 6 + 6-layer tiny Deformable DETR on 2
    lanes: ``odam.msda`` 12 times (6 encoder, 6 decoder), inside
    ``odam.detr.encoder`` and ``odam.detr.decoder``, both inside
    ``odam.detr``; on the CPU MSDA's plain calls equal the span count and
    its ``SAMPLES`` are 2 x (tokens x 4 heads x 4 levels x 4 points x 6 +
    8 queries x 4 x 4 x 4 x 6)."""
    model = _tiny(enc_layers=6, dec_layers=6)
    assoc = t_assoc.build_associator(t_assoc.AssociatorConfig(
        descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
        self_gnn_layers=("self",), sinkhorn_iterations=5), seed=1, device="cpu")
    cfg = t_proc.PipelineConfig(**PIPE)
    runner = t_sp.SceneParallelRunner(model, assoc, cfg, 2, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    meta = np.zeros((2, 18), np.float32)
    meta[:, 1:17] = np.eye(4, dtype=np.float32).reshape(16)
    meta[:, 17] = 1.0
    Ks = torch.tensor([[[100.0, 0, 32], [0, 100, 32], [0, 0, 1]]] * 2)
    stores = t_trk.init_store_lanes(2, cfg.max_tracks, cfg.window, "cpu")
    logs = t_trk.init_log_lanes(2, cfg.max_log_frames, cfg.max_dets, "cpu")
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        runner.step(stores, logs, frames, meta, Ks, 64, 64)
    block = metrics.snapshot()["profiled"]
    spans = block["spans"]
    assert spans["odam.msda"]["count"] == 12
    assert spans["odam.detr.encoder"]["count"] == spans["odam.detr.decoder"]["count"] == 1
    names = {r["id"]: r["name"] for r in block["last"]}
    parent = {r["name"]: names.get(r["parent"]) for r in block["last"]}
    assert parent["odam.detr.encoder"] == parent["odam.detr.decoder"] == "odam.detr"
    msda_parents = {names.get(r["parent"]) for r in block["last"] if r["name"] == "odam.msda"}
    assert msda_parents == {"odam.detr.encoder", "odam.detr.decoder"}
    counters = block["counters"]
    assert counters["msda.PLAIN_CALLS.ms_deform_attn"] == 12
    assert counters["msda.LAUNCHES.ms_deform_attn"] == 0
    tokens = 8 * 8 + 4 * 4 + 2 * 2 + 1
    assert counters["msda.SAMPLES.ms_deform_attn"] == 2 * (tokens + 8) * 4 * 4 * 4 * 6
    metrics.reset()


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.h100
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("queries", [None, 300])
def test_msda_kernel_matches_the_plain_route_on_the_card(card, dtype, queries):
    """At the cell's levels (17,821 tokens), 8 heads of 32, 4 points, batch
    2, the encoder's queries (every token) and the decoder's (300), within
    ``chip_smoke.msda_bar``: float32 within 1e-5 of the largest output (sum
    order, pixel rounding); bfloat16 within one unit in the last place of
    each output (2^-7 of it) plus that.  A plain route with its locations
    rounded to bfloat16 fails the same bar, so the test would see the kernel
    take bf16 locations."""
    import sys

    sys.path.insert(0, ROOT)
    from chip_smoke import msda_bar, msda_inputs

    value, shapes, starts, loc, w = msda_inputs(2, queries, dtype, card, levels=CELL_LEVELS)
    launches = kernels.counts("LAUNCHES")["ms_deform_attn"]
    with torch.no_grad():
        got = msda.ms_deform_attn(value, shapes, starts, loc, w).float()
        want = msda.ms_deform_attn(value, shapes, starts, loc, w, use_kernels=False).float()
        rounded = msda.ms_deform_attn(value, shapes, starts, loc.to(torch.bfloat16).float(), w,
                                      use_kernels=False).float()
    torch.cuda.synchronize()
    assert kernels.counts("LAUNCHES")["ms_deform_attn"] == launches + 1
    bound, _ = msda_bar(want, dtype)
    assert bool(((got - want).abs() <= bound).all())
    assert not bool(((rounded - want).abs() <= bound).all())


@pytest.mark.h100
def test_on_the_card_every_msda_span_launches_the_kernel(card):
    """A 6 + 6-layer tiny Deformable DETR (hidden 64, 2 heads of 32) on the
    card, one forward of 2 lanes under the profiler: 12 ``odam.msda`` spans,
    12 kernel launches (bfloat16), no plain call; the heads equal the plain
    route's (``use_kernels=False``) within 0.05 of their largest value
    (bf16 activations through 12 layers)."""
    kw = dict(enc_layers=6, dec_layers=6, nheads=2)
    state = _tiny(**kw).state_dict()
    bf, plain = (t_detr.detector_from_cfg({**TINY, **kw}, dtype=torch.bfloat16,
                                          use_kernels=k).to(card).eval() for k in (True, False))
    bf.load_state_dict(state)
    plain.load_state_dict(state)
    x = torch.randn(2, 96, 96, 3, generator=torch.Generator().manual_seed(2)).to(card)
    metrics.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = bf(x, lanes=2)
        torch.cuda.synchronize()
    block = metrics.snapshot()["profiled"]
    assert block["spans"]["odam.msda"]["count"] == 12
    assert block["counters"]["msda.LAUNCHES.ms_deform_attn"] == 12
    assert block["counters"]["msda.LAUNCHES_BY_DTYPE.ms_deform_attn.bfloat16"] == 12
    assert block["counters"]["msda.PLAIN_CALLS.ms_deform_attn"] == 0
    with torch.no_grad():
        want = plain(x, lanes=2)
    for k in ("pred_logits", "pred_boxes", "pred_obj_features"):
        a, b = got[k].float(), want[k].float()
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max()), k
    metrics.reset()

