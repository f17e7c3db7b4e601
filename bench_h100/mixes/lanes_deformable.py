"""The ``lanes`` traffic on a Deformable DETR detector: P live scans a step
through ``SceneParallelRunner.step``, with each lane's reply read back, as
:mod:`.lanes` drives it and checks it (``Mix.judge``).

What differs from :class:`.lanes.Mix`:

- set-up builds the program's detector with its factory,
  ``odam_torch.models.detr.detector_from_cfg`` (the configuration's
  ``transformer: deformable``), and raises at once where the program has no
  such factory or its detector holds no multi-scale deformable attention
  (``sampling_offsets``), before any weight is drawn;
- the seeded weights (:mod:`..weights`) get Deformable DETR's own init of
  ``sampling_offsets.bias`` (the sampling grid of upstream's
  ``_reset_parameters``) and a standard normal ``level_embed``, both drawn
  before either model loads them;
- the plain reference is :mod:`..reference.deformable`; the control keeps
  its TF32 products on (fp8 operands, as the lanes' control);
- the per-layer record counts the deformable detector's FLOPs, its
  attention kernel calls and its MSDA calls (:mod:`..roofline_deformable`);
- the log-assignment is held by ``z_norm``, the widest lane-step's gap,
  and not by ``z_median``, the median lane-step's, which is read and
  printed (``UNCOMPARED``): in this cell the fp8 control's least
  ``z_median`` is only 1.25x the program's widest, too close for a limit
  with room on both sides, while its least ``z_norm`` is 2.4x (the limits
  file has the readings).  Without ``z_norm`` a Sinkhorn cut short passes
  at this cell's size.

:meth:`Mix.location_control_check` judges the reference with its sampling
locations rounded to bfloat16 in the program's place: a reading of what the
check sees of the program's float32 locations.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .. import generators, roofline, roofline_deformable, weights
from ..reference import associator as ref_assoc
from ..reference import detector as ref_det
from ..reference import deformable as ref_def
from ..reference import lap as ref_lap
from ..reference import layers as ref_layers
from ..reference import tracking as ref_trk
from . import lanes


# numbers of the check printed beside the compared ones, not compared
UNCOMPARED = ("z_median", "slots_unlike_reference")


class Mix(lanes.Mix):
    def setup(self) -> None:
        from odam_torch.models import associator as assoc_mod
        from odam_torch.models import detr as detr_mod
        from odam_torch.runtime import processor as proc_mod
        from odam_torch.runtime import scene_parallel as sp_mod
        from odam_torch.runtime import tracker

        c, t, dev, P = self.config, self.traffic, self.device, self.lanes
        dtype = lanes.DTYPES[c["dtype"]]
        factory = getattr(detr_mod, "detector_from_cfg", None)
        if factory is None:
            raise RuntimeError("the program has no detector factory "
                               "(odam_torch.models.detr.detector_from_cfg): it cannot build "
                               "Deformable DETR")
        with torch.device("meta"):
            detr = factory(c["model"], dtype=dtype)
            assoc = assoc_mod.Associator(assoc_mod.AssociatorConfig.from_cfg(c["model"],
                                                                               dtype=dtype))
        shapes = weights.module_shapes(detr)
        if not any(k.endswith("sampling_offsets.weight") for k in shapes):
            raise RuntimeError(f"the program's detector ({type(detr).__name__}) holds no "
                               "multi-scale deformable attention")
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        self.weights = {"detr": weights.seeded_state(shapes, gen, dev),
                        "assoc": weights.seeded_state(weights.module_shapes(assoc), gen, dev)}
        self._deformable_init(self.weights["detr"], gen)
        detr = detr.to_empty(device=dev)
        detr.load_state_dict(self.weights["detr"])
        assoc = assoc.to_empty(device=dev)
        assoc.load_state_dict(self.weights["assoc"])
        self.pipeline = dict(c["pipeline"])
        self.runner = sp_mod.SceneParallelRunner(detr, assoc, proc_mod.PipelineConfig(
            **self.pipeline), P, device=dev)

        self.pool = generators.frame_pool(gen, int(t["pool_frames"]), P, self.img_h,
                                          self.img_w, dev)
        rng = np.random.default_rng(self.seed)
        self.phases = rng.uniform(-math.pi, math.pi, P)
        pc = self.runner.cfg
        fills = [generators.filled_window(rng, pc.max_tracks, pc.window, self.img_h,
                                          self.img_w, int(t["store_tracks"]),
                                          int(t["store_history"])) for _ in range(P)]
        store = tracker.init_store_lanes(P, pc.max_tracks, pc.window, dev)
        self.stores = store._replace(**{k: torch.from_numpy(np.stack([f[k] for f in fills]))
                                        .to(dev) for k in fills[0]})
        self.logs = tracker.init_log_lanes(P, pc.max_log_frames, pc.max_dets, dev)
        self.first_frame = int(t["store_history"])
        K = generators.intrinsics(self.img_h, self.img_w)
        self.Ks = torch.from_numpy(np.stack([K] * P)).to(dev)
        self.checked = sorted(np.random.default_rng(self.seed + 1).uniform(
            0.0, 1.0, int(t["checked_steps"])).tolist())
        for _ in range(int(t["warmup_steps"])):
            self.unit()
        self.steps.clear()

    def check(self) -> dict:
        numbers = super().check()
        for name in UNCOMPARED:
            print(f"read {name}: {numbers.get(name)} (not compared)", file=sys.stderr)
        return numbers

    def _deformable_init(self, state: dict, gen: torch.Generator) -> None:
        """Upstream's sampling grid in every ``sampling_offsets.bias`` and a
        standard normal ``level_embed`` (from ``gen``)."""
        m = self.config["model"]
        grids = {key: ref_def.sampling_offsets_grid(int(m["nheads"]),
                                                    int(m["num_feature_levels"]), points)
                 for key, points in (("self_attn", int(m["enc_n_points"])),
                                     ("cross_attn", int(m["dec_n_points"])))}
        for k in state:
            if k.endswith("sampling_offsets.bias"):
                state[k] = grids[k.split(".")[-3]].to(state[k].device)
        state["level_embed"] = torch.randn(state["level_embed"].shape, generator=gen,
                                           device=state["level_embed"].device)

    # -------------------------------------------------------- per layer
    def layer_record(self) -> dict:
        m, p = self.config["model"], self.runner.cfg
        assoc = roofline.associator_flops(
            p.max_tracks, p.window, p.max_dets, int(m["descriptor_dim"]),
            tuple(m["keypoint_encoder"]), len(m["self_GNN_layers"]), tuple(m["GNN_layers"]))
        dtype = self.config["dtype"]
        return {"steps": self.steps, "frames_per_unit": self.lanes,
                "model_flops_per_frame": roofline_deformable.detector_flops(
                    self.img_h, self.img_w, m) + assoc,
                "attention_calls": roofline_deformable.lane_step_attention(
                    self.lanes, m, p.max_tracks, p.max_dets, dtype),
                "msda_calls": roofline_deformable.lane_step_msda(
                    self.lanes, self.img_h, self.img_w, m, dtype)}

    # ------------------------------------------------------------ check
    def _models(self, quant: str | None):
        c = self.config
        detr = ref_def.DeformableDETR(ref_def.DeformableConfig.from_model(c["model"]))
        assoc = ref_assoc.Associator(ref_assoc.AssociatorConfig.from_model(c["model"]))
        detr.load_state_dict(self.weights["detr"])
        assoc.load_state_dict(self.weights["assoc"])
        detr.allow_tf32 = quant is not None       # the control's TF32 products
        return (ref_layers.set_quant(detr.to(self.device).eval(), quant),
                ref_layers.set_quant(assoc.to(self.device).eval(), quant))

    def judge(self, got: dict[int, ref_trk.StepRecord | None]) -> dict:
        """:meth:`.lanes.Mix.judge` with one change: a detection slot the step
        fills must be one that the reference's postprocess fills from the
        step's own heads (the NMS and the top-k exact), and no longer one
        that it fills from the reference's heads.  With 300 queries the
        seeded detector keeps about 27 of its queries through the NMS, under
        the 30 slots, and that count moves with the heads' rounding: the
        reference's own heads rounded to bfloat16 keep 26.  So the slot
        fill against the reference's heads is read, not compared:
        ``slots_unlike_reference``, the slots that one side fills and the
        other does not, over the kept lane-steps.  Every other number is
        as there (the rows of the emitted queries against the reference's
        rows of the same queries, the states, the association, the store).
        """
        gaps = {k: 0.0 for k in ("state_gap", "track_gap", "z_median", "row_gap",
                                 "store_gap")}
        z_lanes: list[tuple[float, float, float]] = []   # (gap, centred gap, row residual)
        n = {"lane_steps": 0, "detections": 0, "slots_unlike_reference": 0}
        pc, P = self.pipeline, self.lanes
        w, h = float(self.img_w), float(self.img_h)
        frame = np.array([w, h, w, h] * 2, np.float32)
        thr = float(pc["match_threshold"])

        def widen(name, value):
            gaps[name] = max(gaps[name], float(value))

        with lanes._Flags(tf32=False), torch.no_grad():
            detr, assoc = self._models(None)
            for f, g in got.items():
                if g is None:
                    n["lane_steps"] += P
                    for name in gaps:
                        widen(name, 1.0)
                    continue
                s = self.sampled[f]
                stores, frames, fids, T_wcs = self._inputs(f, s)
                heads = ref_trk.detector_heads(detr, frames, lanes.REFERENCE_BLOCK)
                cand = ref_det.decode(heads, w, h, self.Ks)
                _, valid_r = ref_det.select(cand, float(pc["detect_threshold"]),
                                            int(pc["max_dets"]))
                # the queries the step emitted: its own heads, decoded and selected
                mine = ref_det.decode(g.heads, w, h, self.Ks)
                order_p, valid_p = ref_det.select(mine, float(pc["detect_threshold"]),
                                                  int(pc["max_dets"]))
                labels = ref_det.gather(mine, order_p, valid_p)
                emitted = ref_det.gather(cand, order_p, valid_p)._replace(
                    classes=labels.classes, angle_deg=labels.angle_deg)
                _, rows_r = ref_trk.rows_for(emitted, fids, T_wcs, w, h, bool(pc["no_code"]))
                Z, _ = assoc(g.tracks79, g.active, g.det79, g.det_valid, thr)
                own = ref_lap.match_by_score(torch.exp(g.log_assignment[:, :-1, :-1].float()),
                                             thr, g.active, g.det_valid)
                a, b = g.heads["pred_obj_features"].float(), heads["pred_obj_features"].float()
                widen("state_gap", ((a - b).flatten(1).norm(dim=1)
                                    / b.flatten(1).norm(dim=1)).max())
                for p in range(P):
                    n["lane_steps"] += 1
                    t79 = ref_trk.prepare_track_inputs(
                        stores[p], T_wcs[p], self.Ks[p], w, h, int(pc["track_bbox_samples"]),
                        pc["track_bbox_mode"])
                    widen("track_gap", ((g.tracks79[p].float() - t79).abs()
                                        / t79.abs().clamp(min=1.0)).max())
                    if not torch.equal(g.active[p].cpu(), stores[p].active.cpu()):
                        widen("track_gap", 1.0)
                    cells = (torch.cat([g.active[p], g.active.new_ones(1)])[:, None]
                             & torch.cat([g.det_valid[p], g.det_valid.new_ones(1)])[None, :])
                    z_lanes.append(lanes._z_gaps(g.log_assignment[p].float(), Z[p], cells))
                    kp = int(valid_p[p].sum())
                    n["detections"] += kp
                    if not torch.equal(valid_p[p].cpu(), g.det_valid[p].cpu()):
                        widen("row_gap", 1.0)
                    n["slots_unlike_reference"] += int((valid_p[p] != valid_r[p]).sum())
                    if kp:
                        q = order_p[p, :kp]
                        widen("row_gap", lanes._row_gap(g.rows[p, :kp].float().cpu().numpy(),
                                                        rows_r[p, :kp].cpu().numpy(),
                                                        frame).max())
                        logp = torch.log(cand.probs[p, q].clamp(min=1e-30))
                        cls = mine.classes[p, q, None].long()
                        widen("row_gap", (logp.amax(-1) - logp.gather(1, cls)[:, 0]).max())
                        al = cand.angle_logits[p, q]
                        bins = mine.angle_logits[p, q].argmax(-1, keepdim=True)
                        widen("row_gap", (al.amax(-1) - al.gather(1, bins)[:, 0]).max())
                    valid = g.det_valid[p]
                    after, ids = ref_trk.update(float(pc["score_threshold"]), stores[p], Z[p],
                                                g.matches[p], valid, rows_r[p])
                    gap, diff = lanes._store_gap(tuple(g.stores[p]), tuple(after), frame)
                    diff += int((g.ids[p].cpu() != ids.cpu()).sum())
                    diff += int((own[p].cpu() != g.matches[p].cpu()).sum())
                    widen("store_gap", max(gap, 1.0 if diff else 0.0))
        if z_lanes:
            worst = max(z_lanes)
            gaps["z_median"] = max(gaps["z_median"], float(np.median([z[0] for z in z_lanes])))
            n.update(z_norm=worst[0], z_worst_centered=worst[1], z_worst_rows=worst[2],
                     rows_median=float(np.median([z[2] for z in z_lanes])))
        return {**gaps, **n}

    def location_control_records(self) -> dict[int, ref_trk.StepRecord]:
        """The kept steps as the float32 reference makes them with every
        sampling location rounded to bfloat16."""
        out = {}
        with lanes._Flags(tf32=False), torch.no_grad():
            detr, assoc = self._models(None)
            for m in detr.msda_modules():
                m.round_locations = True
            for f, s in sorted(self.sampled.items()):
                stores, frames, fids, T_wcs = self._inputs(f, s)
                out[f] = ref_trk.lane_step(self.pipeline, detr, assoc, stores, frames, fids,
                                           T_wcs, self.Ks, float(self.img_w), float(self.img_h),
                                           lanes.REFERENCE_BLOCK)
        return out

    def location_control_check(self) -> dict:
        return self.judge(self.location_control_records())
