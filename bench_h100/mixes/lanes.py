"""Traffic of P live scans at once: ``SceneParallelRunner.step`` on P lanes a
step, as a closed loop of P clients that each wait for their frame's reply.

A unit is one step: the step's P uint8 frames (from a pool made at set-up
from the seed, pinned on the host) and poses handed to ``step``, then each
lane's reply read back to the host: its detection count and the track id
of each detection slot.  Every lane's store starts with ``store_tracks`` of
``max_tracks`` tracks holding ``store_history`` observations each.

``correct``: for ``checked_steps`` steps drawn from the seed over the
window, the plain reference (:mod:`bench_h100.reference.tracking`) runs the
step in float32 from the program's own store before it (the store is the
step's input; the reference follows the program step by step) on the same
frames and weights, and the program's detector state, track inputs,
log-assignment, logged rows, track ids and store after the step are
compared with it.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import generators, roofline, weights
from ..reference import associator as ref_assoc
from ..reference import detector as ref_det
from ..reference import lap as ref_lap
from ..reference import layers as ref_layers
from ..reference import tracking as ref_trk

# Columns of a logged 82-column row compared as numbers: the box and the
# projected box in pixels (compared in units of the frame), and the dims, the
# world centre and the score (|a - b| / max(1, |b|)).  The class (column 1)
# and the azimuth (column 12) are argmaxes, judged by their logits.
PIXELS = np.r_[2:6, 78:82]
VALUES = np.r_[6:12, 13]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Frames a call of the reference detector: it runs once the program is freed,
# in blocks, so that its activations stay under the program's peak.
REFERENCE_BLOCK = 4


class Mix:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.lanes = int(traffic["lanes"])
        self.img_h, self.img_w = int(config["frame"]["height"]), int(config["frame"]["width"])
        self.steps: list[dict] = []     # one record a unit of the window
        self.n_steps = 0                # steps run, warm-up included
        self.sampled: dict[int, dict] = {}

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from odam_torch.models import associator as assoc_mod
        from odam_torch.models import detr as detr_mod
        from odam_torch.runtime import processor as proc_mod
        from odam_torch.runtime import scene_parallel as sp_mod
        from odam_torch.runtime import tracker

        c, t, dev, P = self.config, self.traffic, self.device, self.lanes
        dtype = DTYPES[c["dtype"]]
        with torch.device("meta"):
            detr = detr_mod.DETR(detr_mod.DETRConfig.from_cfg(c["model"], dtype=dtype))
            assoc = assoc_mod.Associator(assoc_mod.AssociatorConfig.from_cfg(c["model"],
                                                                               dtype=dtype))
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        self.weights = {
            "detr": weights.seeded_state(weights.module_shapes(detr), gen, dev),
            "assoc": weights.seeded_state(weights.module_shapes(assoc), gen, dev)}
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

    def _meta(self, f: int) -> np.ndarray:
        meta = np.zeros((self.lanes, 18), np.float32)
        meta[:, 0] = self.first_frame + f
        meta[:, 1:17] = np.stack([generators.lane_pose(f, p, self.phases[p]).reshape(16)
                                  for p in range(self.lanes)])
        meta[:, 17] = 1.0
        return meta

    # -------------------------------------------------------------- units
    def unit(self, window_frac: float | None = None) -> None:
        """One step and its readback.  ``window_frac``, the share of the
        window gone, decides whether this step is kept for the check; a kept
        step's detector heads and association are copied as they are made."""
        f = self.n_steps
        frames = self.pool[f % self.pool.shape[0]]
        meta = self._meta(f)
        before = self.stores
        keep = window_frac is not None and bool(self.checked) and window_frac >= self.checked[0]
        seen = self._watch() if keep else None
        t0 = time.perf_counter()
        with record_function("bench.step"):
            res = self.runner.step(self.stores, self.logs, frames, meta, self.Ks,
                                   self.img_h, self.img_w)
        t1 = time.perf_counter()
        with record_function("bench.readback"):
            reply = torch.cat([res.n_detections[:, None], res.log.ids[:, f]], dim=1).cpu()
        t2 = time.perf_counter()
        self.stores, self.logs = res.store, res.log
        self.n_steps += 1
        self.steps.append({"issue_s": t1 - t0, "latency_s": t2 - t0, "t0": t0, "t2": t2,
                           "detections": int(reply[:, 0].sum())})
        if keep:
            for h in seen.pop("hooks"):
                h.remove()
            self.checked.pop(0)
            self.sampled[f] = {"before": before, "after": res.store, "meta": meta, **seen}

    def _watch(self) -> dict:
        """Forward hooks that copy the program's detector heads and its
        associator's inputs and outputs in the next step."""
        seen: dict = {}

        def on_detr(module, args, out):
            seen["heads"] = {k: out[k].float().clone() for k in ref_trk.HEADS}

        def on_assoc(module, args, out):
            seen["assoc"] = ([a.clone() for a in args[:4]], out.log_assignment.clone(),
                             out.matches.clone())

        seen["hooks"] = [self.runner.detr.register_forward_hook(on_detr),
                         self.runner.associator.register_forward_hook(on_assoc)]
        return seen

    def end_to_end(self, window_s: float) -> dict:
        lat = sorted(s["latency_s"] for s in self.steps for _ in range(self.lanes))
        return {"frames_per_s": len(self.steps) * self.lanes / window_s,
                "frame_p95_ms": 1e3 * float(np.percentile(lat, 95, method="higher"))}

    def attempted(self) -> tuple[int, int]:
        return len(self.steps) * self.lanes, 0

    # -------------------------------------------------------- per layer
    def layer_record(self) -> dict:
        m, p = self.config["model"], self.runner.cfg
        dc5 = bool(m["dilation"])
        stages, (fh, fw) = roofline.resnet50_flops(self.img_h, self.img_w, dc5)
        tokens = fh * fw
        d = int(m["hidden_dim"])
        detr = sum(stages.values()) + 2.0 * tokens * 2048 * d + roofline.transformer_heads_flops(
            tokens, int(m["num_queries"]), d, int(m["dim_feedforward"]), int(m["enc_layers"]),
            int(m["dec_layers"]))
        assoc = roofline.associator_flops(
            p.max_tracks, p.window, p.max_dets, int(m["descriptor_dim"]),
            tuple(m["keypoint_encoder"]), len(m["self_GNN_layers"]), tuple(m["GNN_layers"]))
        calls = roofline.lane_step_attention(
            self.lanes, tokens, int(m["num_queries"]), d, int(m["nheads"]),
            int(m["enc_layers"]), int(m["dec_layers"]), p.max_tracks, p.max_dets,
            int(m["descriptor_dim"]), 4, tuple(m["GNN_layers"]), self.config["dtype"])
        return {"steps": self.steps, "frames_per_unit": self.lanes,
                "model_flops_per_frame": detr + assoc, "attention_calls": calls}

    # ------------------------------------------------------------ check
    def release(self) -> None:
        """Keep what the check reads (the kept steps' stores, heads,
        association and logged rows and ids), free the rest of the program."""
        for f, s in self.sampled.items():
            s["rows"] = self.logs.rows[:, f].clone()
            s["ids"] = self.logs.ids[:, f].clone()
        del self.runner, self.logs, self.stores
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _models(self, quant: str | None):
        c = self.config
        detr = ref_det.DETR(ref_det.DetectorConfig.from_model(c["model"]))
        assoc = ref_assoc.Associator(ref_assoc.AssociatorConfig.from_model(c["model"]))
        detr.load_state_dict(self.weights["detr"])
        assoc.load_state_dict(self.weights["assoc"])
        return (ref_layers.set_quant(detr.to(self.device).eval(), quant),
                ref_layers.set_quant(assoc.to(self.device).eval(), quant))

    def _inputs(self, f: int, s: dict):
        P = self.lanes
        stores = [ref_trk.TrackStore(*[x[p].clone() for x in s["before"]]) for p in range(P)]
        frames = self.pool[f % self.pool.shape[0]].to(self.device)
        T_wcs = torch.from_numpy(s["meta"][:, 1:17].reshape(P, 4, 4)).to(self.device)
        return stores, frames, s["meta"][:, 0].tolist(), T_wcs

    def program_records(self) -> dict[int, ref_trk.StepRecord | None]:
        """The kept steps as the program made them."""
        out = {}
        for f, s in sorted(self.sampled.items()):
            if "heads" not in s or "assoc" not in s:
                out[f] = None            # the step ran no detector or no associator
                continue
            (tracks79, active, det79, det_valid), Z, matches = s["assoc"]
            out[f] = ref_trk.StepRecord(
                heads=s["heads"], det_valid=det_valid, rows=s["rows"], ids=s["ids"],
                stores=[ref_trk.TrackStore(*[x[p] for x in s["after"]])
                        for p in range(self.lanes)],
                tracks79=tracks79, active=active, det79=det79, log_assignment=Z,
                matches=matches)
        return out

    def control_records(self) -> dict[int, ref_trk.StepRecord]:
        """The kept steps as the reference one precision below the
        configuration's makes them, from the same stores, frames and weights:
        fp8 operands where the program computes in bfloat16 (every Dense and
        Conv), TF32 products where it computes in float32 (the track inputs'
        re-projection, Sinkhorn's scores)."""
        out = {}
        with _Flags(tf32=True), torch.no_grad():
            detr, assoc = self._models("fp8")
            for f, s in sorted(self.sampled.items()):
                stores, frames, fids, T_wcs = self._inputs(f, s)
                out[f] = ref_trk.lane_step(self.pipeline, detr, assoc, stores, frames, fids, T_wcs,
                                           self.Ks, float(self.img_w), float(self.img_h),
                                           REFERENCE_BLOCK)
        return out

    def check(self) -> dict:
        return self.judge(self.program_records())

    def control_check(self) -> dict:
        """The check with the control (:meth:`control_records`) in the program's place."""
        return self.judge(self.control_records())

    def judge(self, got: dict[int, ref_trk.StepRecord | None]) -> dict:
        """The numbers that decide ``correct``: each the widest, over the kept
        steps and lanes, of a gap measured against the float32 reference.

        - ``state_gap``: the detector's last decoder state (every query's
          features, from which the heads read) against the reference's on the
          same frame, ||a - b|| / ||b|| a lane;
        - ``track_gap``: the associator's track input against the
          reference's re-projection of the store before the step,
          |a - b| / max(1, |b|) (the boxes are in units of the frame);
        - ``z_median``: the step's log-assignment against the reference
          associator's (the GNN, Sinkhorn) on the step's own inputs, over
          the entries of active tracks, valid detections and the dustbins,
          ||a - b|| / ||b|| a lane-step, the median over the kept
          lane-steps.  Read beside it: ``z_norm``, the widest lane-step;
          at that lane-step ``z_worst_centered``, the same gap of the two
          log-assignments with each row's and column's mean taken out
          (what Sinkhorn's row and column potentials cannot move), and
          ``z_worst_rows``, how far the reference's own rows are from the
          marginals that Sinkhorn converges to (|log of a track row's
          sum|, the widest; ``rows_median``, the median lane-step's);
        - ``row_gap``: each logged row against the reference's row for the
          query the step emitted in that slot: the box and the projected box
          in units of the frame, the dims, the world centre and the score as
          |a - b| / max(1, |b|); and the emitted class's log-probability and
          the emitted angle bin's logit below the reference's best for that
          query;
        - ``store_gap``: the lane's store after the step against the
          reference's update of the store before it with the reference's row
          for each emitted query (with the step's class and angle bin) and
          the step's choices, over its float fields as for the rows.

        Faults that no precision makes read 1: in every gap, a kept step that
        ran no detector or no associator; in ``row_gap`` a detection
        slot that the reference and the step do not both fill; in
        ``track_gap`` an active mask that is not the store's; in
        ``store_gap`` a logged id or an integer field of the store that
        differs, or a choice that is not the exact decode of the step's own
        log-assignment.
        """
        gaps = {k: 0.0 for k in ("state_gap", "track_gap", "z_median", "row_gap",
                                 "store_gap")}
        z_lanes: list[tuple[float, float, float]] = []   # (gap, centred gap, row residual)
        n = {"lane_steps": 0, "detections": 0}
        pc, P = self.pipeline, self.lanes
        w, h = float(self.img_w), float(self.img_h)
        frame = np.array([w, h, w, h] * 2, np.float32)
        thr = float(pc["match_threshold"])

        def widen(name, value):
            gaps[name] = max(gaps[name], float(value))

        with _Flags(tf32=False), torch.no_grad():
            detr, assoc = self._models(None)
            for f, g in got.items():
                if g is None:
                    n["lane_steps"] += P
                    for name in gaps:
                        widen(name, 1.0)
                    continue
                s = self.sampled[f]
                stores, frames, fids, T_wcs = self._inputs(f, s)
                heads = ref_trk.detector_heads(detr, frames, REFERENCE_BLOCK)
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
                    z_lanes.append(_z_gaps(g.log_assignment[p].float(), Z[p], cells))
                    kp = int(valid_p[p].sum())
                    n["detections"] += kp
                    if not (torch.equal(valid_p[p], valid_r[p])
                            and torch.equal(valid_p[p].cpu(), g.det_valid[p].cpu())):
                        widen("row_gap", 1.0)
                    if kp:
                        q = order_p[p, :kp]
                        widen("row_gap", _row_gap(g.rows[p, :kp].float().cpu().numpy(),
                                                  rows_r[p, :kp].cpu().numpy(), frame).max())
                        logp = torch.log(cand.probs[p, q].clamp(min=1e-30))
                        cls = mine.classes[p, q, None].long()
                        widen("row_gap", (logp.amax(-1) - logp.gather(1, cls)[:, 0]).max())
                        al = cand.angle_logits[p, q]
                        bins = mine.angle_logits[p, q].argmax(-1, keepdim=True)
                        widen("row_gap", (al.amax(-1) - al.gather(1, bins)[:, 0]).max())
                    valid = g.det_valid[p]
                    after, ids = ref_trk.update(float(pc["score_threshold"]), stores[p], Z[p],
                                                g.matches[p], valid, rows_r[p])
                    gap, diff = _store_gap(tuple(g.stores[p]), tuple(after), frame)
                    diff += int((g.ids[p].cpu() != ids.cpu()).sum())
                    diff += int((own[p].cpu() != g.matches[p].cpu()).sum())
                    widen("store_gap", max(gap, 1.0 if diff else 0.0))
        if z_lanes:
            worst = max(z_lanes)
            gaps["z_median"] = max(gaps["z_median"], float(np.median([z[0] for z in z_lanes])))
            n.update(z_norm=worst[0], z_worst_centered=worst[1], z_worst_rows=worst[2],
                     rows_median=float(np.median([z[2] for z in z_lanes])))
        return {**gaps, **n}


def _z_gaps(zp: torch.Tensor, zr: torch.Tensor, cells: torch.Tensor) -> tuple[float, ...]:
    """One lane-step's log-assignments [T+1, N+1], over ``cells``: (||a - b||
    / ||b||; the same with each row's and column's mean taken out; the
    widest |log of a track row's sum| of ``zr``)."""
    rows, cols = cells.any(1), cells.any(0)
    a, b = zp[rows][:, cols], zr[rows][:, cols]

    def centred(m):
        return m - m.mean(1, keepdim=True) - m.mean(0, keepdim=True) + m.mean()

    residual = torch.logsumexp(b[:-1], dim=1).abs().max() if len(b) > 1 else b.new_zeros(())
    return (float((a - b).norm() / b.norm()),
            float((centred(a) - centred(b)).norm() / centred(b).norm()), float(residual))


def _row_gap(a: np.ndarray, b: np.ndarray, frame: np.ndarray) -> np.ndarray:
    """Gaps of rows [..., 82]: pixels in units of the frame, the rest
    |a - b| / max(1, |b|)."""
    return np.concatenate([np.abs(a[..., PIXELS] - b[..., PIXELS]) / frame,
                           np.abs(a[..., VALUES] - b[..., VALUES])
                           / np.maximum(1.0, np.abs(b[..., VALUES]))], axis=-1)


class _Flags:
    """TF32 products on or off inside a ``with`` block."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _store_gap(a: tuple, b: tuple, frame: np.ndarray) -> tuple[float, int]:
    """(largest gap of the float fields, the window's rows as ``_row_gap``
    and the rest |a - b| / max(1, |b|); entries of the integer and boolean
    fields that differ) between two stores."""
    gap, diff = 0.0, 0
    for name, x, y in zip(ref_trk.TrackStore._fields, a, b):
        x, y = x.cpu(), y.cpu()
        if not x.dtype.is_floating_point:
            diff += int((x != y).sum())
        elif name == "window":
            gap = max(gap, float(_row_gap(x.numpy(), y.numpy(), frame).max()))
        elif x.numel():
            gap = max(gap, float(((x - y).abs() / y.abs().clamp(min=1.0)).max()))
    return gap, diff
