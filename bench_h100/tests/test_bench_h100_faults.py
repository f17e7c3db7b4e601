"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at tiny sizes, with one fault planted in the program: a step
that returns its state unchanged, half of the lanes left out, an answer
altered where it is produced; in the association, Sinkhorn cut short and
the track inputs shifted; in the scene end, a solve cut short and its
boxes moved.  (One chip: no exchange between chips to
leave out.)  The control, the reference at the precision one below the
configuration's in the program's place, must come out not correct too: at
tiny size here for the lanes (fp8 operands), and at the cells' own sizes on
the card (``test_bench_h100_card.py``).
"""
from __future__ import annotations

import time

import pytest
import torch

from bench_h100 import calibrate, manifest, run


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# Windows long enough at tiny size that the check keeps steps and scene ends
# (a tiny lane step takes ~0.5 s on the CPU): each test asserts that the
# check ran and that the number meant to catch its fault fails.
SECONDS = {"odam_r50.lanes16": 4.0, "odam_r50.scene_end": 3.0}
COUNTS = {"odam_r50.lanes16": "lane_steps", "odam_r50.scene_end": "scene_ends"}


def _run(root, cell, catches):
    out = run.run_cell(cell, 11, SECONDS[cell], False, torch.device("cpu"), root=root,
                       pkg=root / "pkg")
    compared = out["compared"]
    assert compared[COUNTS[cell]]["holds"], compared
    assert not out["correct"] and not compared[catches]["holds"], compared


def _lane_fault(monkeypatch, fault):
    from odam_torch.ops import sinkhorn
    from odam_torch.runtime import processor as proc_mod
    from odam_torch.runtime import scene_parallel as sp_mod

    if fault == "sinkhorn":
        real_ot = sinkhorn.log_optimal_transport

        def short(scores, alpha, iters=100, **kwargs):
            return real_ot(scores, alpha, iters=3, **kwargs)

        monkeypatch.setattr(sinkhorn, "log_optimal_transport", short)
        return
    if fault == "track_inputs":
        real_tracks = proc_mod.prepare_track_inputs_lanes

        def shifted(*args, **kwargs):
            out = real_tracks(*args, **kwargs)
            out[..., 2:6] = torch.where(out[..., 2:6] >= 0, out[..., 2:6] + 0.05, out[..., 2:6])
            return out

        monkeypatch.setattr(proc_mod, "prepare_track_inputs_lanes", shifted)
        return
    real = sp_mod.SceneParallelRunner.step

    def step(self, stores, logs, images, meta, Ks, img_h, img_w):
        if fault == "unchanged":
            time.sleep(0.1)        # in a step's time: the log holds 6000 steps
            return proc_mod.FrameResult(store=stores, log=logs,
                                        n_detections=torch.zeros(self.lanes, dtype=torch.int32))
        res = real(self, stores, logs, images, meta, Ks, img_h, img_w)
        if fault == "half":
            keep = torch.arange(self.lanes) < self.lanes // 2
            store = type(stores)(*[torch.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
                                   for a, b in zip(res.store, stores)])
            return res._replace(store=store)
        idx = (res.log.count - 1).long()
        lane = torch.arange(self.lanes)
        res.log.rows[lane, idx, :, 2:6] *= 1.5           # the boxes, as produced
        return res

    monkeypatch.setattr(sp_mod.SceneParallelRunner, "step", step)


@pytest.mark.parametrize("fault,catches", [("unchanged", "state_gap"), ("half", "store_gap"),
                                           ("altered", "row_gap"), ("sinkhorn", "z_median"),
                                           ("track_inputs", "track_gap")])
def test_a_broken_lane_step_is_not_correct(tiny_root, monkeypatch, fault, catches):
    _lane_fault(monkeypatch, fault)
    _run(tiny_root, "odam_r50.lanes16", catches)


@pytest.mark.parametrize("fault,catches", [("unchanged", "solve1_gap"), ("altered", "solve2_gap"),
                                           ("truncated", "solve1_gap"), ("corners", "solve1_gap")])
def test_a_broken_scene_end_is_not_correct(tiny_root, monkeypatch, fault, catches):
    from odam_torch.mapping import optimizer
    from odam_torch.runtime import processor as proc_mod

    if fault == "unchanged":
        real = optimizer.solve_step

        def solve_step(params, state, *args, **kwargs):
            _, new_state, loss = real(params, state, *args, **kwargs)
            return params, new_state, loss

        monkeypatch.setattr(optimizer, "solve_step", solve_step)
    elif fault == "altered":
        monkeypatch.setattr(proc_mod.OdamPipeline, "merge_process",
                            lambda self, data: list(data["tracks"]))
    elif fault == "truncated":
        real_opt = optimizer.optimize_superquadrics

        def optimize(*args, **kwargs):
            return real_opt(*args, **{**kwargs, "n_iters": 3})

        monkeypatch.setattr(optimizer, "optimize_superquadrics", optimize)
    else:
        real_optim = proc_mod.OdamPipeline.optim_process

        def optim_process(self, tracks):
            out = real_optim(self, tracks)
            out["bboxes_qc"] = [c + 0.1 for c in out["bboxes_qc"]]
            return out

        monkeypatch.setattr(proc_mod.OdamPipeline, "optim_process", optim_process)
    _run(tiny_root, "odam_r50.scene_end", catches)


def test_the_lane_control_is_not_correct_at_tiny_size(tiny_root):
    (reading,) = calibrate.readings("odam_r50.lanes16", [], [11], SECONDS["odam_r50.lanes16"],
                                    torch.device("cpu"), root=tiny_root, pkg=tiny_root / "pkg")
    correct, compared = run.evaluate(reading["numbers"],
                                     manifest.limits("odam_r50.lanes16", tiny_root / "pkg"))
    assert reading["of"] == "control" and reading["numbers"]["lane_steps"] >= 1
    assert not correct, compared
