"""The port's tracing (``odam_torch.utils.metrics``) on the CPU at tiny size:
spans off, under ``torch.profiler`` and under ``enable()``, the scene end's
spans and its Adam counter, and the counters' one home in ``snapshot()``.
Each test states its bar."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from odam_torch import native
from odam_torch.mapping import lm_solver, optimizer
from odam_torch.models import associator as t_assoc
from odam_torch.models import detr as t_detr
from odam_torch.ops import cuda_attention as t_ca
from odam_torch.ops import lap as t_lap
from odam_torch.runtime import processor as t_proc
from odam_torch.runtime import scene_parallel as t_sp
from odam_torch.runtime import tracker as t_trk
from odam_torch.utils import metrics
from test_torch_mapping import _synthetic_tracks
from torch_threads import one_torch_thread  # noqa: F401

# each span of a lane step and its parent
LANE_TREE = {"odam.step": None, "odam.transport": "odam.step", "odam.detr": "odam.step",
             "odam.postprocess": "odam.step", "odam.track_update": "odam.step",
             "odam.track_inputs": "odam.track_update", "odam.associator": "odam.track_update",
             "odam.gnn": "odam.associator", "odam.sinkhorn": "odam.associator",
             "odam.lap": "odam.associator", "odam.store_update": "odam.track_update"}
SCENE_END_TREE = {"odam.optim": None, "odam.optim.constraints": "odam.optim",
                  "odam.optim.upload": "odam.optim", "odam.optim.solve": "odam.optim",
                  "odam.optim.readback": "odam.optim", "odam.merge": None,
                  "odam.merge.cost": "odam.merge", "odam.merge.linkage": "odam.merge"}
P = 2


@pytest.fixture(autouse=True)
def _fresh():
    metrics.disable()
    metrics.reset()
    yield
    metrics.disable()
    metrics.reset()


@pytest.fixture(scope="module")
def lanes():
    """tests/test_torch_scene_parallel.py's tiny models and PipelineConfig
    (a DETR with 8 queries and hidden 32, a 32-d associator, the greedy
    decode) in a runner of 2 lanes, and one step's inputs."""
    dkw = dict(num_classes=8, num_queries=8, hidden_dim=32, nheads=4, enc_layers=1,
               dec_layers=1, dim_feedforward=32, aux_loss=False, backbone="tiny",
               backbone_stage=3)
    akw = dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
               self_gnn_layers=("self",), sinkhorn_iterations=20, decode="greedy")
    pkw = dict(detect_threshold=0.0, score_threshold=0.0, max_tracks=8, max_dets=5, window=6,
               track_bbox_samples=64, max_log_frames=16)
    runner = t_sp.SceneParallelRunner(
        t_detr.build_detr(t_detr.DETRConfig(**dkw), seed=0, device="cpu"),
        t_assoc.build_associator(t_assoc.AssociatorConfig(**akw), seed=1, device="cpu"),
        t_proc.PipelineConfig(**pkw), P, device="cpu")
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (P, 64, 64, 3), dtype=np.uint8)
    meta = np.zeros((P, 18), np.float32)
    meta[:, 1:17] = np.eye(4, dtype=np.float32).reshape(16)
    meta[:, 17] = 1.0
    Ks = torch.from_numpy(np.stack([np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]],
                                             np.float32)] * P))
    return runner, frames, meta, Ks


def _step(lanes):
    runner, frames, meta, Ks = lanes
    cfg = runner.cfg
    stores = t_trk.init_store_lanes(P, cfg.max_tracks, cfg.window, "cpu")
    logs = t_trk.init_log_lanes(P, cfg.max_log_frames, cfg.max_dets, "cpu")
    return runner.step(stores, logs, frames, meta, Ks, 64, 64)


@pytest.fixture
def range_calls(monkeypatch):
    """Counts the dispatcher's record_function entries (each range opened)."""
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(*args, **kwargs):
        calls.append(args[0])
        return enter(*args, **kwargs)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counting)
    with torch.profiler.record_function("odam.test_patch_counts"):
        pass
    assert calls == ["odam.test_patch_counts"]
    calls.clear()
    return calls


def _by_id(block):
    return {s["id"]: s for s in block["last"]}


def _assert_tree(block, tree):
    """Every recorded span's parent is the one ``tree`` names, and every name
    of ``tree`` was recorded with a self time >= 0."""
    spans = _by_id(block)
    for s in spans.values():
        parent = spans[s["parent"]]["name"] if s["parent"] is not None else None
        assert parent == tree[s["name"]], s
        assert s["end_ns"] >= s["start_ns"]
    assert set(block["spans"]) == set(tree)
    for name, agg in block["spans"].items():
        assert agg["count"] >= 1 and 0 <= agg["self_s"] <= agg["total_s"], (name, agg)


def test_an_untraced_lane_step_records_nothing_and_opens_no_range(lanes, range_calls):
    """Off: no span recorded, no record_function call."""
    _step(lanes)
    assert range_calls == []
    snap = metrics.snapshot()
    assert snap["profiled"] is None and snap["enabled"] is None


def test_a_traced_lane_step_records_its_tree_as_profiler_ranges(lanes, range_calls):
    """Under torch.profiler: two steps record LANE_TREE, each span's parent
    and step id right (postprocess twice a step), self times >= 0, every
    span a range among the profiler's events.  A later traced block starts
    afresh."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(lanes)
        _step(lanes)
    block = metrics.snapshot()["profiled"]
    _assert_tree(block, LANE_TREE)
    n = lanes[0].n_steps
    for name, agg in block["spans"].items():
        assert agg["count"] == (4 if name == "odam.postprocess" else 2), name
    spans = _by_id(block)
    assert sorted(s["request"] for s in spans.values() if s["name"] == "odam.step") == [n - 1, n]
    for s in spans.values():
        root = s
        while root["parent"] is not None:
            root = spans[root["parent"]]
        assert s["request"] == root["request"]
    events = {e.name for e in prof.events()}
    assert set(LANE_TREE) <= events and set(LANE_TREE) <= set(range_calls)
    step = next(s for s in spans.values() if s["name"] == "odam.step")
    stages = sum(s["end_ns"] - s["start_ns"] for s in spans.values()
                 if s["parent"] == step["id"])
    assert stages <= step["end_ns"] - step["start_ns"]

    _step(lanes)                                   # untraced: the block stays
    assert metrics.snapshot()["profiled"]["spans"]["odam.step"]["count"] == 2
    with profile(activities=[ProfilerActivity.CPU]):
        _step(lanes)
    block = metrics.snapshot()["profiled"]
    assert block["spans"]["odam.step"]["count"] == 1
    assert {s["request"] for s in block["last"]} == {lanes[0].n_steps}


def test_enable_records_host_times_without_ranges(lanes, range_calls):
    """enable() without a profiler: the lane step's host times, no range and
    no traced block; disable() keeps them and records no more."""
    metrics.enable()
    _step(lanes)
    snap = metrics.snapshot()
    assert range_calls == [] and snap["profiled"] is None
    _assert_tree(snap["enabled"], LANE_TREE)
    assert snap["enabled"]["spans"]["odam.step"]["total_s"] > 0
    metrics.disable()
    _step(lanes)
    assert metrics.snapshot()["enabled"]["spans"]["odam.step"]["count"] == 1


def test_a_scene_end_shares_one_sequence_id_and_counts_its_adam_iterations():
    """optim_process, merge_process, optim_process at 3 iterations under
    enable(): the odam.optim.* and odam.merge.* spans all carry the
    sequence's id, and optim.adam_iterations reads 2 x 3."""
    n_iters = 3
    pipe = t_proc.OdamPipeline(None, torch.nn.Identity(), t_proc.PipelineConfig(
        max_objs=8, max_views=16, optim_samples=50, optim_iters=n_iters), device="cpu")
    tracks, seq, _ = _synthetic_tracks(np.random.default_rng(6), n_frames=16)
    pipe.init_sequence(np.eye(3), seq["img_h"], seq["img_w"])
    pipe.sequence.update(usable_frames=seq["usable_frames"], P_cws=seq["P_cws"])
    metrics.enable()
    pipe.optim_process(pipe.merge_process(pipe.optim_process(tracks)))
    block = metrics.snapshot()["enabled"]
    _assert_tree(block, SCENE_END_TREE)
    assert {s["request"] for s in block["last"]} == {pipe.sequence["id"]}
    assert block["spans"]["odam.optim.solve"]["count"] == 2
    assert block["counters"]["optim.adam_iterations"] == 2 * n_iters

    pipe.init_sequence(np.eye(3), seq["img_h"], seq["img_w"])
    assert pipe.sequence["id"] > block["last"][0]["request"]


def test_snapshot_exports_the_registered_counters_and_reset_clears_them(lanes):
    """The attention, LAP, LM, optim and build groups hold the modules' own
    dicts' values; reset() zeroes every count and forgets every span, and
    leaves the build records."""
    metrics.enable()
    _step(lanes)
    t_lap.solve(torch.rand(2, 3, 4))
    lm_solver.HOST_READS["fallback_any"] += 2
    optimizer.COUNTS["adam_iterations"] += 5
    counters = metrics.snapshot()["counters"]
    assert counters["attention"] == {
        "LAUNCHES": t_ca.LAUNCHES, "PLAIN_CALLS": t_ca.PLAIN_CALLS,
        "LAUNCHES_BY_DTYPE": t_ca.LAUNCHES_BY_DTYPE,
        "PLAIN_CALLS_BY_DTYPE": t_ca.PLAIN_CALLS_BY_DTYPE,
        "LAUNCHES_BY_BATCH": t_ca.LAUNCHES_BY_BATCH, "ALIGN_COPIES": t_ca.ALIGN_COPIES}
    assert counters["attention"]["PLAIN_CALLS"]["fused_attention"] > 0
    assert counters["lap"] == {"LAUNCHES": t_lap.LAUNCHES, "PLAIN_CALLS": t_lap.PLAIN_CALLS,
                               "ROUTE_LAUNCHES": t_lap.ROUTE_LAUNCHES}
    assert counters["lap"]["PLAIN_CALLS"]["lap_solve"] >= 1
    assert counters["lm"] == {"HOST_READS": lm_solver.HOST_READS}
    assert counters["optim"] == optimizer.COUNTS
    assert counters["build"] == {"attention": t_ca.BUILD_INFO, "lap": t_lap.BUILD_INFO,
                                 "native": native.BUILD_INFO}
    assert metrics.snapshot()["enabled"]["counters"]["optim.adam_iterations"] == 0

    build = {k: dict(v) for k, v in counters["build"].items()}
    metrics.reset()
    snap = metrics.snapshot()
    assert snap["enabled"]["spans"] == {} and snap["enabled"]["last"] == []
    assert snap["profiled"] is None
    for group in ("attention", "lap", "lm", "optim"):
        assert not any(metrics._flat("", snap["counters"][group], {}).values()), group
    assert t_ca.PLAIN_CALLS["fused_attention"] == t_lap.PLAIN_CALLS["lap_solve"] == 0
    assert snap["counters"]["build"] == build
