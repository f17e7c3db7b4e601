"""Traffic of scan ends: one scene end after the other, each
``optim_process -> merge_process -> optim_process`` on its own synthetic
scene, called as ``SceneParallelRunner.finalize`` calls them, without
models.

Set-up draws ``pool_scenes`` scenes from the seed (``synthetic_scene``:
``objects`` objects on a ring of ``views`` look-at cameras, ``fragmented``
of them seen as two tracks split at a view, so the first solve has
``objects + fragmented`` tracks and the merge has real work); the window
takes them in turn.

``correct``: for ``checked_scene_ends`` of the window's scene ends, drawn
from the seed, the plain reference (:mod:`bench_h100.reference.scene_end`)
builds the constraints and runs the whole solve on the same tracks, and the
program's solve is compared with it: the losses of its first
``CHECKED_ITERATIONS`` iterations, the length of its loss log, and its
boxes against those of its own parameters at the end; of the first solve,
and of the second, whose tracks the reference merges itself from the
program's first solve (the 200-iteration solve amplifies rounding until the
boxes differ by chance, so the reference follows the program from that
point).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import generators
from ..reference import scene_end as ref_scene

# The solve's first iterations, whose losses are compared one by one: the
# solve amplifies rounding (an extreme sample point that switches moves the
# gradient), so that later a lower precision's losses lie no more than ~2x
# farther from the reference's than the program's own do (PERF.md).
CHECKED_ITERATIONS = 5
LOOK_AT = (5, 25, 50, 100, 150, 200)


class Mix:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.img_h, self.img_w = int(config["frame"]["height"]), int(config["frame"]["width"])
        self.steps: list[dict] = []
        self.kept: list[dict] = []

    def setup(self) -> None:
        from odam_torch.runtime import processor as proc_mod

        t = self.traffic
        rng = np.random.default_rng(self.seed)
        self.scenes = []
        for _ in range(int(t["pool_scenes"])):
            tracks, frame_ids, T_wcs, K, _ = generators.synthetic_scene(
                rng, int(t["objects"]), int(t["views"]), self.img_h, self.img_w)
            self.scenes.append({"tracks": generators.fragment(rng, tracks, int(t["fragmented"])),
                                "frame_ids": frame_ids, "T_wcs": T_wcs, "K": K})
        self.pipeline = dict(self.config["pipeline"])
        self.pipe = proc_mod.OdamPipeline(None, torch.nn.Identity(),
                                          proc_mod.PipelineConfig(**self.pipeline),
                                          device=self.device)
        self.checked = set(np.random.default_rng(self.seed + 1).choice(
            int(t["checked_from"]), size=int(t["checked_scene_ends"]), replace=False).tolist())
        self.n_units = 0
        warm = proc_mod.PipelineConfig(**{**self.pipeline,
                                          "optim_iters": int(t["warmup_iterations"])})
        full, self.pipe.cfg = self.pipe.cfg, warm
        self.unit()
        self.pipe.cfg = full
        self.steps.clear()
        self.kept.clear()
        self.n_units = 0

    def unit(self, window_frac: float | None = None) -> None:
        """One scene end, as ``finalize`` runs a lane's."""
        i = self.n_units % len(self.scenes)
        s = self.scenes[i]
        pipe = self.pipe
        t0 = time.perf_counter()
        K = np.asarray(s["K"], np.float32)
        pipe.init_sequence(K, self.img_h, self.img_w)
        seq = pipe.sequence
        seq["usable_frames"] = [int(f) for f in s["frame_ids"]]
        seq["T_wcs"] = [np.asarray(T, np.float32) for T in s["T_wcs"]]
        seq["P_cws"] = [K[:3, :3] @ np.linalg.inv(np.asarray(T, np.float64)).astype(
            np.float32)[:3, :] for T in s["T_wcs"]]
        t1 = time.perf_counter()
        with record_function("bench.optim"):
            first = pipe.optim_process(s["tracks"])
        t2 = time.perf_counter()
        with record_function("bench.merge"):
            merged = pipe.merge_process(first)
        t3 = time.perf_counter()
        with record_function("bench.optim"):
            second = pipe.optim_process(merged)
        t4 = time.perf_counter()
        self.n_units += 1
        self.steps.append({"optim_s": (t2 - t1) + (t4 - t3), "merge_s": t3 - t2,
                           "latency_s": t4 - t0, "t0": t0, "t2": t4,
                           "tracks_in": len(s["tracks"]), "tracks_merged": len(merged)})
        if window_frac is not None and i in self.checked and i not in {k["scene"] for k in
                                                                      self.kept}:
            self.kept.append({"scene": i, "first": first, "merged": merged, "second": second})

    def end_to_end(self, window_s: float) -> dict:
        return {"scene_end_s": window_s / len(self.steps)}

    def attempted(self) -> tuple[int, int]:
        return len(self.steps), 0

    def layer_record(self) -> dict:
        return {"steps": self.steps}

    def release(self) -> None:
        del self.pipe
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def program_outputs(self) -> list[dict]:
        return [{"scene": k["scene"], "first_out": k["first"], "second_out": k["second"]}
                for k in self.kept]

    def _ref_solve(self, scene: int, tracks, n_iters: int | None) -> dict:
        s = self.scenes[scene]
        K = np.asarray(s["K"], np.float64)[:3, :3]
        P_cws = [(K @ np.linalg.inv(np.asarray(T, np.float64))[:3, :]).astype(np.float32)
                 for T in s["T_wcs"]]
        return ref_scene.optim_process(tracks, s["frame_ids"], P_cws, float(self.img_h),
                                       float(self.img_w), self.pipeline, self.device, n_iters)

    def reference_runs(self, tf32: bool = False, first: list[dict] | None = None) -> list[dict]:
        """The reference's two whole solves of each kept scene end; its merge
        reads ``first`` (the program's first solve, or the control's).
        ``tf32`` runs it with TF32 products (the control)."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            out = []
            for k, src in zip(self.kept, first or [kept["first"] for kept in self.kept]):
                one = self._ref_solve(k["scene"], self.scenes[k["scene"]]["tracks"], None)
                merged = ref_scene.merge_process(src, self.scenes[k["scene"]]["frame_ids"])
                two = self._ref_solve(k["scene"], merged, None)
                out.append({"scene": k["scene"], "first_out": one, "second_out": two,
                            "merged": len(merged)})
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return out

    def control_outputs(self) -> list[dict]:
        """The reference in the program's place with TF32 products: the whole
        first solve, its own merge, the whole second solve."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            out = []
            for k in self.kept:
                s = self.scenes[k["scene"]]
                first = self._ref_solve(k["scene"], s["tracks"], None)
                merged = ref_scene.merge_process(first, s["frame_ids"])
                second = self._ref_solve(k["scene"], merged, None)
                out.append({"scene": k["scene"], "first_out": first, "second_out": second})
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return out

    def check(self) -> dict:
        return self.compare(self.program_outputs(), self.reference_runs())

    def control_check(self) -> dict:
        """The check with the reference at TF32 products in the program's place."""
        ctl = self.control_outputs()
        return self.compare(ctl, self.reference_runs(first=[c["first_out"] for c in ctl]))

    def compare(self, got: list[dict], ref: list[dict]) -> dict:
        """The numbers that decide ``correct``, each the widest over the kept
        scene ends: ``solve1_gap`` of the first solve and ``solve2_gap`` of
        the second, each the wider of

        - the losses of its first ``CHECKED_ITERATIONS`` iterations against
          the reference's, |a - b| / |b|, and
        - each box at its end against the box that the reference makes of
          the solve's own parameters: the farthest of its corners from the
          other box's nearest corner, over the diagonal (``solve*_box_fit``).

        A solve whose loss log is not ``optim_iters`` long, or that keeps
        another number of tracks than the reference, reads infinity.  Read
        beside them: ``solve*_loss_at_<k>``, the loss gap over the first k
        iterations; ``solve*_box_gap`` and ``solve*_box_max``, each box
        against the reference's solve's, the farthest corner over the
        diagonal, the median object and the widest.
        """
        n, iters = CHECKED_ITERATIONS, int(self.pipeline["optim_iters"])
        looks = ("box_fit", "box_gap", "box_max") + tuple(f"loss_at_{k}" for k in LOOK_AT)
        out = {f"solve{i}_{k}": 0.0 for i in (1, 2) for k in ("gap",) + looks}
        out["scene_ends"] = len(ref)

        def widen(name, value):
            out[name] = max(out[name], float(value))

        for g, r in zip(got, ref):
            for key, i in (("first_out", 1), ("second_out", 2)):
                gs, rs = g[key], r[key]
                a, b = np.asarray(gs["loss_log"], np.float64), np.asarray(rs["loss_log"],
                                                                         np.float64)
                ca, cb = np.asarray(gs["bboxes_qc"]), np.asarray(rs["bboxes_qc"])
                if len(a) != iters or len(b) != iters or ca.shape != cb.shape:
                    for k in ("gap",) + looks:
                        widen(f"solve{i}_{k}", np.inf)
                    continue
                gap = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
                for k in LOOK_AT:
                    widen(f"solve{i}_loss_at_{k}", gap[:k].max())
                fit = 0.0
                if len(cb):
                    own = ref_scene.boxes_of(gs["quadrics"], rs["optimized"], rs["boxes_det"],
                                             int(self.pipeline["optim_samples"]), self.device)
                    diag = np.linalg.norm(cb.max(axis=1) - cb.min(axis=1), axis=-1)
                    nearest = np.linalg.norm(ca[:, :, None] - own[:, None], axis=-1).min(-1)
                    fit = float((nearest.max(-1) / diag).max())
                    far = np.linalg.norm(ca - cb, axis=-1).max(axis=-1) / diag
                    widen(f"solve{i}_box_gap", np.median(far))
                    widen(f"solve{i}_box_max", far.max())
                widen(f"solve{i}_box_fit", fit)
                widen(f"solve{i}_gap", max(gap[:n].max(), fit))
        return out
