"""The pipeline: detect -> associate -> track per frame, then map and merge.

Counterpart of ``odam_tpu/runtime/processor.py`` (the online mode with the
"sampled" track re-projection and the Adam solve).  One step runs, on the
device: the DETR forward, postprocess with the fixpoint 3D NMS,
detection-row assembly and the lift to world, the re-projection of each
track's mean-state superquadric surface, the associator (GNN + Sinkhorn),
and the static-shape track-store update with its FrameLog.

Two places differ from the JAX step, both on purpose:

- The JAX step chooses between its init and association branches with a
  ``lax.cond`` on ``store.count > 0``.  Here the host knows the answer: at
  the end of a step ``count`` is copied without blocking into pinned memory
  with an event, and read after the next frame's forward is queued.  Once
  the store holds a track it never empties (association keeps matched
  tracks and refills every slot it recycles), so the copy stops then.
- The exact Hungarian decode runs on the host (:mod:`odam_torch.ops.lap`),
  one blocking copy of the [T+1, N+1] log assignment per associated frame.

``OdamPipeline.host_syncs`` counts the blocking waits of both kinds.

At scene end, ``optim_process`` packs the tracks into fixed-shape
constraints on the host, solves all objects' superquadrics on the device
and copies the results back once; ``merge_process`` fuses fragmented tracks
on the host.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..data.loader import to_device
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, yuv420_to_normalized_device
from ..mapping import constraints, merge, optimizer, prior
from ..mapping import superquadric as sq
from ..models import detr as detr_mod
from ..models.associator import Associator
from ..models.detr import DETR
from ..utils import boxes as box_ops
from ..utils import geometry as geo
from . import tracker


@dataclass(frozen=True)
class PipelineConfig:
    detect_threshold: float = 0.6
    match_threshold: float = 0.1
    score_threshold: float = 0.8
    max_tracks: int = 64
    max_dets: int = 30
    window: int = 100
    representation: str = "super_quadric"
    use_prior: bool = True
    no_code: bool = True
    track_bbox_samples: int = 1000   # surface samples for track re-projection
    optim_solver: str = "adam"       # "lm" is not ported yet (ROADMAP Queue 1 item 7)
    optim_iters: int = 200
    optim_samples: int = 1000
    min_views: int = 10
    robust_init: bool = False        # median (vs the reference's mean) mapping init
    max_objs: int = 64               # mapping-stage object capacity
    max_views: int = 256             # mapping-stage views per object
    max_log_frames: int = 6000       # device observation-log capacity per chunk


class FrameResult(NamedTuple):
    store: tracker.TrackStore
    log: tracker.FrameLog
    n_detections: torch.Tensor   # [] int32, on the device


def detection_rows_camera(dets: detr_mod.Detections, frame_id: float, img_w: float,
                          img_h: float) -> torch.Tensor:
    """The 79-dim camera-frame detection rows of image 0:
    [frame_id, class, bbox_norm(4), dims(3), t_co(3), sin azi, cos azi,
    score, code(64) = -1]; invalid slots are -1."""
    b = 0
    N = dets.valid.shape[1]
    dev = dets.valid.device
    angle_rad = dets.angle_deg[b] * (math.pi / 180.0)
    rows = torch.cat([
        torch.full((N, 1), float(frame_id), device=dev),
        dets.classes[b][:, None].float(),
        dets.boxes[b] / box_ops.xyxy_scale(img_w, img_h, dev),
        dets.dims[b],
        dets.t_co[b],
        torch.sin(angle_rad)[:, None],
        torch.cos(angle_rad)[:, None],
        dets.scores[b][:, None],
        torch.full((N, 64), -1.0, device=dev),
    ], dim=-1)
    return torch.where(dets.valid[b][:, None], rows, -1.0)


def lift_rows_to_world(det79: torch.Tensor, det_valid: torch.Tensor, T_wc: torch.Tensor,
                       img_w: float, img_h: float, no_code: bool = True) -> torch.Tensor:
    """Camera-frame 79-dim rows -> world-frame 82-dim track rows:
    t_wo = T_wc t_co, azi_wo = atan2(sin, cos) + camera azimuth, bbox in
    pixels in columns 2:6 and again in 78:82."""
    N = det79.shape[0]
    dev = det79.device
    cam_azi = geo.camera_azimuth(T_wc)
    t_wo = geo.transform_points(T_wc, det79[:, 9:12])
    azi_wo = torch.atan2(det79[:, 12], det79[:, 13]) + cam_azi
    bbox_px = det79[:, 2:6] * box_ops.xyxy_scale(img_w, img_h, dev)
    code = torch.full((N, 64), -1.0, device=dev) if no_code else det79[:, 15:79]
    rows = torch.cat([det79[:, 0:2], bbox_px, det79[:, 6:9], t_wo, azi_wo[:, None],
                      det79[:, 14:15], code, bbox_px], dim=-1)
    return torch.where(det_valid[:, None], rows, -1.0)


def prepare_track_inputs(store: tracker.TrackStore, T_wc: torch.Tensor, K: torch.Tensor,
                         img_w: float, img_h: float, n_samples: int = 1000) -> torch.Tensor:
    """The [T, W, 79] associator input from the track store ("sampled" mode).

    Each track's projected bbox is refreshed from its mean-state ellipsoid
    (shape logits 0, epsilon 0.9): ``n_samples`` surface points projected
    into the current camera with a plain z division, normalized and clipped
    to [-1, 2], and written into every window row; world state is re-encoded
    in the current camera frame; invalid window rows are -1.  With
    ``ODAM_FAULT_INJECT=stale_track_bbox`` the rows keep their attach-time
    bbox instead (test instrumentation).
    """
    T_cap, W, _ = store.window.shape
    dev = store.window.device
    t_mean, azi_mean, dims_mean = tracker.mean_state(store)
    T_cw = geo.invert_se3(T_wc)
    params = sq.SQParams(translate=t_mean, angle=azi_mean, scales=torch.sqrt(dims_mean / 2.0),
                         shapes=torch.zeros((T_cap, 2), dtype=t_mean.dtype, device=dev))
    pts_c = geo.transform_points(T_cw, sq.surface_points_world(params, n_samples))
    pix = torch.einsum("ij,tsj->tsi", K, pts_c)
    uv = pix[..., :2] / pix[..., 2:]
    box = torch.cat([uv.amin(dim=1), uv.amax(dim=1)], dim=-1)
    norm = box_ops.xyxy_scale(img_w, img_h, dev)
    box_n = torch.clamp(box / norm, -1.0, 2.0)

    win = store.window
    if os.environ.get("ODAM_FAULT_INJECT") == "stale_track_bbox":
        # Test instrumentation (examples/cli_rehearsal/ablate.py): skip the
        # per-frame refresh and feed each window row's stored attach-time
        # bbox, to show that the rehearsal's F1 catches an injected pipeline
        # bug.  Never set in production.
        box_rows = torch.clamp(win[..., 78:82] / norm, -1.0, 2.0)
    else:
        box_rows = box_n[:, None, :].expand(T_cap, W, 4)
    cam_azi = geo.camera_azimuth(T_wc)
    t_co = geo.transform_points(T_cw, win[..., 9:12].reshape(T_cap * W, 3)).reshape(T_cap, W, 3)
    ang = win[..., 12] - cam_azi
    out = torch.cat([
        win[..., 0:2],
        box_rows,
        win[..., 6:9],
        t_co,
        torch.sin(ang)[..., None],
        torch.cos(ang)[..., None],
        win[..., 13:14],
        win[..., 14:78],
    ], dim=-1)
    slot_valid = ((torch.arange(W, device=dev)[None, :] < store.length[:, None])
                  & store.active[:, None])
    return torch.where(slot_valid[..., None], out, -1.0)


def update_tracks(cfg: PipelineConfig, associator: Associator, store: tracker.TrackStore,
                  log: tracker.FrameLog, det79: torch.Tensor, det82: torch.Tensor,
                  det_valid: torch.Tensor, T_wc: torch.Tensor, K: torch.Tensor,
                  img_w: float, img_h: float, has_tracks: bool
                  ) -> tuple[tracker.TrackStore, tracker.FrameLog]:
    """Associate one frame's detections against the store and update it.

    With an empty store the detections spawn tracks directly; otherwise the
    associator runs and unmatched detections are gated on the dustbin row.
    Slots matched this frame are protected from eviction.
    """
    T_cap = store.capacity
    dev = det79.device
    if not has_tracks:
        store, slots = tracker.assign_new_slots(store, det_valid)
        ok = det_valid & (slots >= 0)
    else:
        with record_function("odam.track_inputs"):
            tracks79 = prepare_track_inputs(store, T_wc, K, img_w, img_h,
                                            cfg.track_bbox_samples)
        with record_function("odam.associator"):
            out = associator(tracks79[None], store.active[None], det79[None],
                             det_valid[None], cfg.match_threshold)
        Z = out.log_assignment[0]
        match = out.matches[0].long()
        N = match.shape[0]
        matched = match >= 0
        gate_row = torch.where(matched, match, T_cap)
        gate = torch.exp(Z[gate_row, torch.arange(N, device=dev)])
        attach_ok = det_valid & (gate >= cfg.score_threshold)
        is_new = attach_ok & ~matched
        matched_mask = tracker.scatter_drop(
            torch.zeros(T_cap, dtype=torch.bool, device=dev), gate_row, torch.ones_like(matched))
        store, new_slots = tracker.assign_new_slots(store, is_new, protected=matched_mask)
        slots = torch.where(matched, match.int(), new_slots)
        ok = attach_ok & (slots >= 0)
    store = tracker.append_rows(store, det82, slots, ok)
    ids = torch.where(ok, store.track_id[torch.clamp(slots.long(), 0, T_cap - 1)], -1)
    return store, tracker.log_frame(log, det82, ids)


def frame_step_body(cfg: PipelineConfig, detr: DETR, associator: Associator,
                    store: tracker.TrackStore, log: tracker.FrameLog, image: torch.Tensor,
                    frame_id: float, T_wc: torch.Tensor, K: torch.Tensor, img_w: float,
                    img_h: float, has_tracks: Callable[[], bool]) -> FrameResult:
    """One step on a normalized float32 [H, W, 3] frame.

    ``has_tracks`` is asked only after the forward, postprocess and row
    assembly are queued, so a wait it makes overlaps them.  The
    ``record_function`` ranges ("odam.*") name the step's stages in a
    torch.profiler trace (``chip_smoke.py --profile`` reads them); they cost
    about a microsecond each when no profiler runs.
    """
    with record_function("odam.detr"):
        outputs = detr(image[None])
    with record_function("odam.postprocess"):
        dets = detr_mod.postprocess(outputs, img_w, img_h, cfg.detect_threshold, K,
                                    max_dets=cfg.max_dets)
        det_valid = dets.valid[0]
        det79 = detection_rows_camera(dets, frame_id, img_w, img_h)
        det82 = lift_rows_to_world(det79, det_valid, T_wc, img_w, img_h, cfg.no_code)
    with record_function("odam.track_update"):
        store, log = update_tracks(cfg, associator, store, log, det79, det82, det_valid,
                                   T_wc, K, img_w, img_h, has_tracks())
    return FrameResult(store=store, log=log, n_detections=det_valid.sum().to(torch.int32))


class OdamPipeline:
    """Host driver around the per-frame step: ``init_sequence(K, img_h,
    img_w)``, then ``process_frame(image, frame_id, T_wc)`` per frame, then
    ``tracks``, ``overflow_report()``, and at scene end ``optim_process`` /
    ``merge_process``.  Runs on the card unless ``device="cpu"``."""

    def __init__(self, detr: DETR, associator: Associator,
                 config: PipelineConfig = PipelineConfig(),
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.detr = detr.to(self.device).eval()
        self.associator = associator.to(self.device).eval()
        self.cfg = config
        self.sequence: dict | None = None
        self.host_syncs = 0   # waits for the store-count flag
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    @property
    def host_syncs_total(self) -> int:
        """Every blocking device-to-host wait of the sequence's steps."""
        return self.host_syncs + self.associator.host_syncs

    def init_sequence(self, K: np.ndarray, img_h: int, img_w: int) -> None:
        cfg, dev = self.cfg, self.device
        K = np.asarray(K, np.float32)
        self.sequence = {
            "K": K,
            "K_dev": torch.from_numpy(np.ascontiguousarray(K[:3, :3])).to(dev),
            "img_h": float(img_h),
            "img_w": float(img_w),
            "store": tracker.init_store(cfg.max_tracks, cfg.window, dev),
            "log": tracker.init_log(cfg.max_log_frames, cfg.max_dets, dev),
            "usable_frames": [],
            "T_wcs": [],
            "P_cws": [],
            "tracks_cache": None,
            "history": {},          # global track id -> [row chunks]
            "frames_in_log": 0,     # host-side log fill counter
            "has_tracks": False,    # store.count > 0, as far as the host knows
            "count_host": None,
            "count_event": None,
        }

    def _normalized_image(self, image) -> torch.Tensor:
        if isinstance(image, tuple):
            y, uv = to_device(image, self.device)
            return yuv420_to_normalized_device(y, uv, self._mean, self._std)
        img = to_device(image, self.device)
        if img.dtype == torch.uint8:
            return (img.float() / 255.0 - self._mean) / self._std
        return img.float()

    def _has_tracks(self) -> bool:
        seq = self.sequence
        if not seq["has_tracks"] and seq["count_host"] is not None:
            if seq["count_event"] is not None:
                seq["count_event"].synchronize()
                self.host_syncs += 1
            seq["has_tracks"] = int(seq["count_host"]) > 0
        return seq["has_tracks"]

    def _publish_count(self, store: tracker.TrackStore) -> None:
        seq = self.sequence
        if seq["has_tracks"]:
            return   # a store that holds a track never empties
        if self.device.type == "cuda":
            if seq["count_host"] is None:
                seq["count_host"] = torch.empty((), dtype=torch.int32, pin_memory=True)
            seq["count_host"].copy_(store.count, non_blocking=True)
            seq["count_event"] = torch.cuda.Event()
            seq["count_event"].record()
        else:
            seq["count_host"] = store.count

    def process_frame(self, image, frame_id: int, T_wc: np.ndarray) -> FrameResult:
        """Run one frame.  ``image`` is uint8 RGB [H, W, 3], normalized
        float32 [H, W, 3], or a YUV 4:2:0 tuple (Y [H, W], UV [H/2, W/2, 2])
        of uint8.  Queues the step without waiting for it, apart from the
        waits counted in ``host_syncs_total``."""
        seq = self.sequence
        if seq is None:
            raise RuntimeError("call init_sequence first")
        seq["usable_frames"].append(int(frame_id))
        T_wc = np.asarray(T_wc, np.float32)
        seq["T_wcs"].append(T_wc)
        seq["P_cws"].append(seq["K"][:3, :3] @ np.linalg.inv(T_wc)[:3, :])
        seq["tracks_cache"] = None

        with torch.no_grad():
            result = frame_step_body(
                self.cfg, self.detr, self.associator, seq["store"], seq["log"],
                self._normalized_image(image), float(frame_id), to_device(T_wc, self.device),
                seq["K_dev"], seq["img_w"], seq["img_h"], self._has_tracks)
        seq["store"] = result.store
        seq["log"] = result.log
        self._publish_count(result.store)
        seq["frames_in_log"] += 1
        if seq["frames_in_log"] >= self.cfg.max_log_frames:
            self._drain_log_chunk()
        return result

    def _drain_log_chunk(self) -> None:
        """Pull the device log into the host history and reset it (triggered
        by the host-side frame counter, so no sync decides it)."""
        seq = self.sequence
        for tid, rows in tracker.drain_log(seq["log"]).items():
            seq["history"].setdefault(tid, []).append(rows)
        seq["log"] = tracker.init_log(self.cfg.max_log_frames, self.cfg.max_dets, self.device)
        seq["frames_in_log"] = 0

    @property
    def tracks(self) -> list[np.ndarray]:
        """Full per-track observation history, grouped by global track id in
        spawn order."""
        seq = self.sequence
        if seq["tracks_cache"] is None:
            merged = {tid: list(chunks) for tid, chunks in seq["history"].items()}
            for tid, rows in tracker.drain_log(seq["log"]).items():
                merged.setdefault(tid, []).append(rows)
            seq["tracks_cache"] = [
                np.concatenate(chunks, axis=0) for _, chunks in sorted(merged.items())
                if sum(len(c) for c in chunks) > 0
            ]
        return seq["tracks_cache"]

    def overflow_report(self, warn: bool = True) -> dict:
        """Capacity counters for the sequence (one device pull)."""
        seq = self.sequence
        report = {
            "n_evicted": int(seq["store"].n_evicted),
            "n_dropped": int(seq["store"].n_dropped),
            "log_frames_lost": int(seq["log"].n_lost),
            "n_track_ids": int(seq["store"].next_id),
        }
        if warn and (report["n_dropped"] or report["log_frames_lost"]):
            logging.getLogger("OdamPipeline").warning("capacity overflow: %s", report)
        return report

    # -------------------------------------------------------------- mapping
    def optim_process(self, tracks: list[np.ndarray]) -> dict:
        """Multi-view superquadric solve over all tracks of the sequence.

        Returns the tracks kept (at most ``max_objs``, longest first, given
        back in input order) with their optimized oriented boxes
        (``bboxes_qc``), detector-average boxes (``bboxes_dl``) and
        parameters (``quadrics``, SQParams of numpy arrays), all numpy, and
        the solve's per-iteration ``loss_log``.
        """
        seq, cfg, dev = self.sequence, self.cfg, self.device
        if cfg.optim_solver != "adam":
            raise NotImplementedError(
                f"optim_solver={cfg.optim_solver!r} is not ported yet (ROADMAP Queue 1 item 7: "
                "mapping/lm_solver.py); use 'adam'")
        sc = constraints.build_scene_constraints(
            tracks, np.asarray(seq["usable_frames"]), np.asarray(seq["P_cws"]),
            seq["img_h"], seq["img_w"], cfg.max_objs, cfg.max_views, cfg.min_views,
            robust_init=cfg.robust_init)

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        init = sq.init_params(on_dev(sc.init_translate), on_dev(sc.init_angle),
                              on_dev(sc.init_dims), cfg.representation)
        res = optimizer.optimize_superquadrics(
            init, on_dev(sc.boxes), on_dev(sc.box_mask), on_dev(sc.view_mask), on_dev(sc.P_cw),
            on_dev(sc.optimize_mask), on_dev(prior.prior_invcov_for_classes(sc.obj_class)),
            n_iters=cfg.optim_iters, n_samples=cfg.optim_samples,
            representation=cfg.representation, use_prior=cfg.use_prior)
        # the host's first read waits for the solve; the rest are copies
        host = [t.cpu().numpy() for t in (res.corners, res.corners_detector, res.loss_log,
                                          *res.params)]
        corners, corners_dl, loss_log, params = host[0], host[1], host[2], host[3:]
        n_objs = int(sc.obj_valid.sum())
        # back to input track order (the constraints sort longest first)
        order = np.argsort([-len(t) for t in tracks], kind="stable")[: sc.boxes.shape[0]]
        inv = {int(t): s for s, t in enumerate(order)}
        out = {"tracks": [], "bboxes_qc": [], "bboxes_dl": [], "quadrics": [],
               "loss_log": loss_log}
        for t_idx in range(len(tracks)):
            if t_idx not in inv or inv[t_idx] >= n_objs:
                continue
            s = inv[t_idx]
            out["tracks"].append(tracks[t_idx])
            out["bboxes_qc"].append(corners[s])
            out["bboxes_dl"].append(corners_dl[s])
            out["quadrics"].append(sq.SQParams(*[np.asarray(leaf[s]) for leaf in params]))
        return out

    def merge_process(self, data: dict) -> list[np.ndarray]:
        """Fuse fragmented tracks by the overlap of their optimized boxes."""
        return merge.merge_tracks(data["tracks"], data["bboxes_qc"],
                                  np.asarray(self.sequence["usable_frames"]))
