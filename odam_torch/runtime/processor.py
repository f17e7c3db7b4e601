"""The pipeline: detect -> associate -> track per frame, then map and merge.

Counterpart of ``odam_tpu/runtime/processor.py``.  One step runs, on the
device: the frame's transport decode (uint8 RGB or YUV 4:2:0, normalized,
optionally resized from its raw size, in the model's dtype), the DETR
forward, postprocess with the fixpoint 3D NMS, detection-row assembly and
the lift to world, the re-projection of each track's mean state ("sampled":
1000 surface points of the mean superquadric; "exact": the closed-form
dual-conic bbox of the mean ellipsoid), the associator (GNN + Sinkhorn),
and the static-shape track-store update with its FrameLog.  The step splits
after the detector: :func:`detect_frame` and :func:`track_step`, so that
the offline mode (:mod:`odam_torch.runtime.offline`) shares the tracking.
:func:`lane_step_body` is the step of P scenes at once, stacked on a lane
axis (:mod:`odam_torch.runtime.scene_parallel`).

One place differs from the JAX step, on purpose.  The JAX step chooses
between its init and association branches with a ``lax.cond`` on
``store.count > 0``.  Here the host knows the answer: at the end of a step
``count`` is copied without blocking into pinned memory with an event, and
read after the next frame's forward is queued.  Once the store holds a track
it never empties (association keeps matched tracks and refills every slot it
recycles), so the copy stops then.  ``OdamPipeline.host_syncs`` counts those
waits, the step's only blocking reads: the exact Hungarian decode runs on
the card in the LAP kernel (:mod:`odam_torch.ops.lap`), so a frame after the
store holds a track waits for nothing.

At scene end, ``optim_process`` packs the tracks into fixed-shape
constraints on the host, solves all objects' superquadrics on the device
(Adam, or LM with its Adam fallback) and copies the results back once;
``merge_process`` fuses fragmented tracks on the host.
``save_sequence_state`` / ``restore_sequence_state`` checkpoint a sequence
mid-scene as a pickle of numpy arrays, which either package can write.
"""
from __future__ import annotations

import itertools
import logging
import math
import os
import pickle
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from .. import resolve_device
from ..data.loader import to_device
from ..data.transforms import (IMAGENET_MEAN, IMAGENET_STD, resize_bilinear_device,
                               yuv420_to_normalized_device)
from ..mapping import constraints, lm_solver, merge, optimizer, prior, quadric
from ..mapping import superquadric as sq
from ..models import detr as detr_mod
from ..models.associator import Associator
from ..models.detr import DETR
from ..utils import boxes as box_ops
from ..utils import geometry as geo
from ..utils import metrics
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
    track_bbox_mode: str = "sampled"  # "sampled" (reference parity) | "exact" (closed form)
    optim_solver: str = "adam"       # "adam" (reference-exact) | "lm" (LM, Adam fallback)
    optim_iters: int = 200
    optim_samples: int = 1000
    min_views: int = 10
    robust_init: bool = False        # median (vs the reference's mean) mapping init
    max_objs: int = 64               # mapping-stage object capacity
    max_views: int = 256             # mapping-stage views per object
    max_log_frames: int = 6000       # device observation-log capacity per chunk
    resize_on_device: bool = False   # accept raw-size frames; resize inside the step


class FrameResult(NamedTuple):
    store: tracker.TrackStore
    log: tracker.FrameLog
    n_detections: torch.Tensor   # [] int32, on the device ([P] in the lane step)


def detection_rows_camera(dets: detr_mod.Detections, frame_id: float | torch.Tensor,
                          img_w: float, img_h: float) -> torch.Tensor:
    """The 79-dim camera-frame detection rows of image 0:
    [frame_id, class, bbox_norm(4), dims(3), t_co(3), sin azi, cos azi,
    score, code(64) = -1]; invalid slots are -1.  ``frame_id`` is a number
    or a float32 tensor of one element."""
    b = 0
    N = dets.valid.shape[1]
    dev = dets.valid.device
    angle_rad = dets.angle_deg[b] * (math.pi / 180.0)
    if isinstance(frame_id, torch.Tensor):
        fid = frame_id.reshape(1, 1).expand(N, 1)
    else:
        fid = torch.full((N, 1), float(frame_id), device=dev)
    rows = torch.cat([
        fid,
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
                         img_w: float, img_h: float, n_samples: int = 1000,
                         mode: str = "sampled") -> torch.Tensor:
    """The [T, W, 79] associator input from the track store.

    Each track's projected bbox is refreshed from its mean state and written
    into every window row, normalized and clipped to [-1, 2].
    ``mode="sampled"``: ``n_samples`` surface points of the mean-state
    superquadric (shape logits 0, epsilon 0.9) projected into the current
    camera with a plain z division.  ``mode="exact"``: the closed-form bbox
    of the dual conic of the mean-state ellipsoid (semi-axes dims / 2), the
    epsilon-1 surface, with no surface samples at all.  World state is
    re-encoded in the current camera frame; invalid window rows are -1.
    With ``ODAM_FAULT_INJECT=stale_track_bbox`` the rows keep their
    attach-time bbox instead (test instrumentation).
    """
    T_cap, W, _ = store.window.shape
    dev = store.window.device
    t_mean, azi_mean, dims_mean = tracker.mean_state(store)
    T_cw = geo.invert_se3(T_wc)
    if mode == "exact":
        Q = quadric.quadric_matrix(t_mean, azi_mean, (dims_mean / 2.0) ** 2)   # [T, 4, 4]
        box = quadric.quadric_bbox(Q, K @ T_cw[:3, :])                          # [T, 4]
    elif mode == "sampled":
        params = sq.SQParams(translate=t_mean, angle=azi_mean,
                             scales=torch.sqrt(dims_mean / 2.0),
                             shapes=torch.zeros((T_cap, 2), dtype=t_mean.dtype, device=dev))
        pts_c = geo.transform_points(T_cw, sq.surface_points_world(params, n_samples))
        pix = torch.einsum("ij,tsj->tsi", K, pts_c)
        uv = pix[..., :2] / pix[..., 2:]
        box = torch.cat([uv.amin(dim=1), uv.amax(dim=1)], dim=-1)
    else:
        raise ValueError(f"unknown track_bbox_mode {mode!r}")
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
    if has_tracks:
        with metrics.span("odam.track_inputs"):
            tracks79 = prepare_track_inputs(store, T_wc, K, img_w, img_h,
                                            cfg.track_bbox_samples, cfg.track_bbox_mode)
        with metrics.span("odam.associator"):
            out = associator(tracks79[None], store.active[None], det79[None],
                             det_valid[None], cfg.match_threshold)
    with metrics.span("odam.store_update"):
        if has_tracks:
            store, slots, ok = _attach(cfg, store, out.log_assignment[0], out.matches[0],
                                       det_valid)
        else:
            store, slots, ok = _spawn(store, det_valid)
        store = tracker.append_rows(store, det82, slots, ok)
        return store, tracker.log_frame(log, det82, _attached_ids(store, slots, ok))


def _spawn(store: tracker.TrackStore, det_valid: torch.Tensor
           ) -> tuple[tracker.TrackStore, torch.Tensor, torch.Tensor]:
    """The empty store's branch: every valid detection spawns a track.
    Returns (store, slots [N], attached [N])."""
    store, slots = tracker.assign_new_slots(store, det_valid)
    return store, slots, det_valid & (slots >= 0)


def _attach(cfg: PipelineConfig, store: tracker.TrackStore, Z: torch.Tensor,
            match: torch.Tensor, det_valid: torch.Tensor
            ) -> tuple[tracker.TrackStore, torch.Tensor, torch.Tensor]:
    """The association branch after the associator: a detection attaches to
    its match, or spawns a track when unmatched, if its assignment score
    (the dustbin row's when unmatched) clears ``score_threshold``; matched
    slots are protected from eviction.  Z [T+1, N+1] log assignment, match
    [N].  Returns (store, slots [N], attached [N])."""
    T_cap = store.capacity
    dev = Z.device
    match = match.long()
    matched = match >= 0
    gate_row = torch.where(matched, match, T_cap)
    gate = torch.exp(Z[gate_row, torch.arange(match.shape[0], device=dev)])
    attach_ok = det_valid & (gate >= cfg.score_threshold)
    is_new = attach_ok & ~matched
    matched_mask = tracker.scatter_drop(
        torch.zeros(T_cap, dtype=torch.bool, device=dev), gate_row, torch.ones_like(matched))
    store, new_slots = tracker.assign_new_slots(store, is_new, protected=matched_mask)
    slots = torch.where(matched, match.int(), new_slots)
    return store, slots, attach_ok & (slots >= 0)


def _attached_ids(store: tracker.TrackStore, slots: torch.Tensor, ok: torch.Tensor
                  ) -> torch.Tensor:
    """The global track id each detection was logged under, -1 where none."""
    T_cap = store.capacity
    return torch.where(ok, store.track_id[torch.clamp(slots.long(), 0, T_cap - 1)], -1)


def detect_frame(cfg: PipelineConfig, detr: DETR, images: torch.Tensor, K: torch.Tensor,
                 img_w: float, img_h: float, lanes: int = 1, shards: int = 1
                 ) -> detr_mod.Detections:
    """DETR forward and postprocess on normalized [B, H, W, 3] frames; K is
    [3, 3] or one per frame, [B, 3, 3]; ``lanes`` and ``shards`` as in
    ``DETR.forward``."""
    with metrics.span("odam.detr"):
        outputs = detr(images, lanes=lanes, shards=shards)
    with metrics.span("odam.postprocess"):
        return detr_mod.postprocess(outputs, img_w, img_h, cfg.detect_threshold, K,
                                    max_dets=cfg.max_dets)


def track_step(cfg: PipelineConfig, associator: Associator, store: tracker.TrackStore,
               log: tracker.FrameLog, dets: detr_mod.Detections, frame_id: float,
               T_wc: torch.Tensor, K: torch.Tensor, img_w: float, img_h: float,
               has_tracks: Callable[[], bool]) -> FrameResult:
    """One image's detections (batch 1) -> rows -> association -> store update.

    ``has_tracks`` is asked only after the row assembly is queued, so a wait
    it makes overlaps the work before it.
    """
    with metrics.span("odam.postprocess"):
        det_valid = dets.valid[0]
        det79 = detection_rows_camera(dets, frame_id, img_w, img_h)
        det82 = lift_rows_to_world(det79, det_valid, T_wc, img_w, img_h, cfg.no_code)
    with metrics.span("odam.track_update"):
        store, log = update_tracks(cfg, associator, store, log, det79, det82, det_valid,
                                   T_wc, K, img_w, img_h, has_tracks())
    return FrameResult(store=store, log=log, n_detections=det_valid.sum().to(torch.int32))


def frame_step_body(cfg: PipelineConfig, detr: DETR, associator: Associator,
                    store: tracker.TrackStore, log: tracker.FrameLog, image: torch.Tensor,
                    frame_id: float, T_wc: torch.Tensor, K: torch.Tensor, img_w: float,
                    img_h: float, has_tracks: Callable[[], bool]) -> FrameResult:
    """One step on a normalized [H, W, 3] frame (in the model's dtype).

    The spans ("odam.*", :func:`odam_torch.utils.metrics.span`) name the
    step's stages: ranges in a torch.profiler trace (``chip_smoke.py
    --profile`` and ``bench_h100`` read them), host times under
    ``metrics.enable()``.  With neither, a span checks two flags and records
    nothing: no clock read and no ``record_function`` call.
    """
    dets = detect_frame(cfg, detr, image[None], K, img_w, img_h)
    return track_step(cfg, associator, store, log, dets, frame_id, T_wc, K, img_w, img_h,
                      has_tracks)


# ---------------------------------------------------------------- lane step
#
# P scenes advance one frame each in one step, every tensor with a leading
# lane axis.  JAX vmaps its one-scene step over the lanes; here the models
# run at batch P (the attention routed on the lane's batch, so each lane's
# calls take the kernels its JAX counterpart takes), the row and track
# functions are the one-scene functions under ``torch.func.vmap``, and
# JAX's ``lax.cond`` on ``store.count > 0``, a select under ``vmap``, is a
# select here too: both branches run for every lane.  So the lane step needs
# no store-count flag, and it makes no blocking read: the exact decode of
# every lane is one launch of the LAP kernel.

def detection_rows_camera_lanes(dets: detr_mod.Detections, frame_ids: torch.Tensor,
                                img_w: float, img_h: float) -> torch.Tensor:
    """:func:`detection_rows_camera` of each lane's image: detections of
    batch P, frame_ids [P] float32 -> [P, N, 79]."""
    per_lane = detr_mod.Detections(*[x[:, None] for x in dets])
    return vmap(detection_rows_camera, in_dims=(0, 0, None, None))(per_lane, frame_ids,
                                                                    img_w, img_h)


lift_rows_to_world_lanes = vmap(lift_rows_to_world, in_dims=(0, 0, 0, None, None, None))
prepare_track_inputs_lanes = vmap(prepare_track_inputs,
                                  in_dims=(0, 0, 0, None, None, None, None))


def _where_lanes(cond: torch.Tensor, new, old):
    """Per lane, ``new`` where ``cond`` [P] is set and ``old`` elsewhere, for
    a tensor or a NamedTuple of tensors with a leading lane axis."""
    if isinstance(new, tuple):
        return type(new)(*[_where_lanes(cond, a, b) for a, b in zip(new, old)])
    return torch.where(cond.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def update_tracks_lanes(cfg: PipelineConfig, associator: Associator,
                        stores: tracker.TrackStore, logs: tracker.FrameLog,
                        det79: torch.Tensor, det82: torch.Tensor, det_valid: torch.Tensor,
                        T_wcs: torch.Tensor, Ks: torch.Tensor, img_w: float, img_h: float,
                        valid: torch.Tensor) -> tuple[tracker.TrackStore, tracker.FrameLog]:
    """:func:`update_tracks` for P lanes at once.  The associator runs for
    every lane, each lane takes its association branch if its store holds a
    track and its spawn branch if not, and a lane whose ``valid`` is unset
    (a padded frame) keeps its store and log as they were."""
    with metrics.span("odam.track_inputs"):
        tracks79 = prepare_track_inputs_lanes(stores, T_wcs, Ks, img_w, img_h,
                                              cfg.track_bbox_samples, cfg.track_bbox_mode)
    with metrics.span("odam.associator"):
        out = associator(tracks79, stores.active, det79, det_valid, cfg.match_threshold,
                         lanes=det79.shape[0])
    with metrics.span("odam.store_update"):
        attached = vmap(partial(_attach, cfg))(stores, out.log_assignment, out.matches,
                                               det_valid)
        spawned = vmap(_spawn)(stores, det_valid)
        has_tracks = stores.count > 0
        store, slots, ok = (_where_lanes(has_tracks, a, b) for a, b in zip(attached, spawned))
        store = tracker.append_rows_lanes(store, det82, slots, ok)
        ids = vmap(_attached_ids)(store, slots, ok)
        return (_where_lanes(valid, store, stores),
                tracker.log_frame_lanes(logs, det82, ids, valid))


def lane_step_body(cfg: PipelineConfig, detr: DETR, associator: Associator,
                   stores: tracker.TrackStore, logs: tracker.FrameLog, images: torch.Tensor,
                   frame_ids: torch.Tensor, T_wcs: torch.Tensor, Ks: torch.Tensor,
                   img_w: float, img_h: float, valid: torch.Tensor) -> FrameResult:
    """One step of P scenes: normalized images [P, H, W, 3] (in the model's
    dtype), frame_ids [P] float32, T_wcs [P, 4, 4], Ks [P, 3, 3], valid [P]
    bool, stores and logs with a leading lane axis.  Each lane gets what
    :func:`frame_step_body` gives its scene; a lane whose frame is padding
    (``valid`` unset) keeps its store and log and counts 0 detections."""
    P = images.shape[0]
    dets = detect_frame(cfg, detr, images, Ks, img_w, img_h, lanes=P)
    with metrics.span("odam.postprocess"):
        det_valid = dets.valid
        det79 = detection_rows_camera_lanes(dets, frame_ids, img_w, img_h)
        det82 = lift_rows_to_world_lanes(det79, det_valid, T_wcs, img_w, img_h, cfg.no_code)
    with metrics.span("odam.track_update"):
        store, log = update_tracks_lanes(cfg, associator, stores, logs, det79, det82,
                                         det_valid, T_wcs, Ks, img_w, img_h, valid)
    n_detections = torch.where(valid, det_valid.sum(dim=-1), 0).to(torch.int32)
    return FrameResult(store=store, log=log, n_detections=n_detections)


def device_images(images, device: torch.device, mean: torch.Tensor, std: torch.Tensor,
                  dtype: torch.dtype, size: tuple[int, int] | None = None) -> torch.Tensor:
    """Frames to normalized [..., H, W, 3] tensors on ``device`` in ``dtype``.

    uint8 RGB is normalized on the device, a YUV 4:2:0 tuple (Y [H, W], UV
    [H/2, W/2, 2] uint8) decoded and normalized there, float frames are
    taken as normalized.  With ``size`` set, a frame of another size is
    resized (bilinear, antialiased, as ``jax.image.resize``) in float32 and
    then cast; JAX resizes after the cast, which is one bf16 rounding apart.
    """
    if isinstance(images, tuple):
        y, uv = to_device(images, device)
        img = yuv420_to_normalized_device(y, uv, mean, std)
    else:
        img = to_device(images, device)
        img = (img.float() / 255.0 - mean) / std if img.dtype == torch.uint8 else img.float()
    if size is not None and tuple(img.shape[-3:-1]) != tuple(size):
        img = resize_bilinear_device(img, *size)
    return img.to(dtype)


# the id of each sequence: the request its spans serve (utils.metrics.span)
_SEQUENCE_IDS = itertools.count(1)


class OdamPipeline:
    """Host driver around the per-frame step: ``init_sequence(K, img_h,
    img_w)``, then ``process_frame(image, frame_id, T_wc)`` per frame, then
    ``tracks``, ``overflow_report()``, and at scene end ``optim_process`` /
    ``merge_process``.  Runs on the card unless ``device="cpu"``.  ``detr``
    is None only in the offline mode's cached-detection pipeline."""

    def __init__(self, detr: DETR | None, associator: Associator,
                 config: PipelineConfig = PipelineConfig(),
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.detr = None if detr is None else detr.to(self.device).eval()
        self.associator = associator.to(self.device).eval()
        self.cfg = config
        self.sequence: dict | None = None
        self.host_syncs = 0   # waits for the store-count flag: the step's only blocking reads
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    @property
    def model_dtype(self) -> torch.dtype:
        """The detector's compute dtype: frames are decoded straight into it."""
        return self.detr.config.dtype if self.detr is not None else torch.float32

    def init_sequence(self, K: np.ndarray, img_h: int, img_w: int) -> None:
        cfg, dev = self.cfg, self.device
        K = np.asarray(K, np.float32)
        self.sequence = {
            "id": next(_SEQUENCE_IDS),
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
        seq = self.sequence
        size = (int(seq["img_h"]), int(seq["img_w"])) if self.cfg.resize_on_device else None
        return device_images(image, self.device, self._mean, self._std, self.model_dtype, size)

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

    def _record_frame(self, frame_id: int, T_wc: np.ndarray) -> np.ndarray:
        """The host's per-frame bookkeeping before a step; returns T_wc as float32."""
        seq = self.sequence
        if seq is None:
            raise RuntimeError("call init_sequence first")
        seq["usable_frames"].append(int(frame_id))
        T_wc = np.asarray(T_wc, np.float32)
        seq["T_wcs"].append(T_wc)
        seq["P_cws"].append(seq["K"][:3, :3] @ np.linalg.inv(T_wc)[:3, :])
        seq["tracks_cache"] = None
        return T_wc

    def _finish_frame(self, result: FrameResult) -> FrameResult:
        seq = self.sequence
        seq["store"] = result.store
        seq["log"] = result.log
        self._publish_count(result.store)
        seq["frames_in_log"] += 1
        if seq["frames_in_log"] >= self.cfg.max_log_frames:
            self._drain_log_chunk()
        return result

    def process_frame(self, image, frame_id: int, T_wc: np.ndarray) -> FrameResult:
        """Run one frame.  ``image`` is uint8 RGB [H, W, 3], normalized
        float32 [H, W, 3], or a YUV 4:2:0 tuple (Y [H, W], UV [H/2, W/2, 2])
        of uint8; with ``resize_on_device`` it may have any size.  Queues the
        step without waiting for it, apart from the waits counted in
        ``host_syncs``."""
        with metrics.span("odam.step", self._sequence_id()):
            T_wc = self._record_frame(frame_id, T_wc)
            seq = self.sequence
            with torch.no_grad():
                with metrics.span("odam.transport"):
                    image, T_wc = self._normalized_image(image), to_device(T_wc, self.device)
                result = frame_step_body(
                    self.cfg, self.detr, self.associator, seq["store"], seq["log"], image,
                    float(frame_id), T_wc, seq["K_dev"], seq["img_w"], seq["img_h"],
                    self._has_tracks)
            return self._finish_frame(result)

    def _sequence_id(self) -> int | None:
        return None if self.sequence is None else self.sequence.get("id")

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
        with metrics.span("odam.optim", self._sequence_id()):
            return self._optim_process(tracks)

    def _optim_process(self, tracks: list[np.ndarray]) -> dict:
        seq, cfg, dev = self.sequence, self.cfg, self.device
        if cfg.optim_solver not in ("adam", "lm"):
            raise ValueError(f"unknown optim_solver {cfg.optim_solver!r}: 'adam' or 'lm'")
        with metrics.span("odam.optim.constraints"):
            sc = constraints.build_scene_constraints(
                tracks, np.asarray(seq["usable_frames"]), np.asarray(seq["P_cws"]),
                seq["img_h"], seq["img_w"], cfg.max_objs, cfg.max_views, cfg.min_views,
                robust_init=cfg.robust_init)

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        with metrics.span("odam.optim.upload"):
            init = sq.init_params(on_dev(sc.init_translate), on_dev(sc.init_angle),
                                  on_dev(sc.init_dims), cfg.representation)
            solver_args = (init, on_dev(sc.boxes), on_dev(sc.box_mask), on_dev(sc.view_mask),
                           on_dev(sc.P_cw), on_dev(sc.optimize_mask),
                           on_dev(prior.prior_invcov_for_classes(sc.obj_class)))
        # the solve only queues work (the LM route's one host read apart)
        with metrics.span("odam.optim.solve"):
            if cfg.optim_solver == "lm":
                # LM for the objects inside its envelope, Adam for the rest
                res = lm_solver.optimize_superquadrics_auto(
                    *solver_args, n_iters=min(cfg.optim_iters, 40),
                    n_samples=cfg.optim_samples, adam_iters=cfg.optim_iters,
                    representation=cfg.representation, use_prior=cfg.use_prior)
            else:
                res = optimizer.optimize_superquadrics(
                    *solver_args, n_iters=cfg.optim_iters, n_samples=cfg.optim_samples,
                    representation=cfg.representation, use_prior=cfg.use_prior)
        # the host's first read waits for the solve; the rest are copies
        with metrics.span("odam.optim.readback"):
            host = [t.cpu().numpy() for t in (res.corners, res.corners_detector, res.loss_log,
                                              *res.params)]
        corners, corners_dl, loss_log, params = host[0], host[1], host[2], host[3:]
        n_objs = int(sc.obj_valid.sum())
        # back to input track order (the constraints sort longest first)
        order = np.argsort([-len(t) for t in tracks], kind="stable")[: sc.boxes.shape[0]]
        inv = {int(t): s for s, t in enumerate(order)}
        out = {"tracks": [], "bboxes_qc": [], "bboxes_dl": [], "quadrics": [],
               "loss_log": loss_log}
        if res.fallback is not None:
            out["n_fallback"] = int(res.fallback.sum())
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
        with metrics.span("odam.merge", self._sequence_id()):
            return merge.merge_tracks(data["tracks"], data["bboxes_qc"],
                                      np.asarray(self.sequence["usable_frames"]))

    # ---------------------------------------------------------- checkpoints
    def save_sequence_state(self, path: str) -> None:
        """Checkpoint the sequence mid-scene (track store, observation log and
        host metadata) as a pickle of numpy arrays and plain containers, in
        the JAX package's layout, so that a crashed run resumes mid-sequence."""
        seq = self.sequence
        state = {
            "K": seq["K"],
            "img_h": seq["img_h"],
            "img_w": seq["img_w"],
            "store": tuple(t.cpu().numpy() for t in seq["store"]),
            "log": tuple(t.cpu().numpy() for t in seq["log"]),
            "usable_frames": seq["usable_frames"],
            "T_wcs": seq["T_wcs"],
            "P_cws": seq["P_cws"],
            "history": seq["history"],
            "frames_in_log": seq["frames_in_log"],
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def restore_sequence_state(self, path: str) -> None:
        """Resume a sequence from ``save_sequence_state``'s pickle, the port's
        or the JAX package's (a pickle runs code as it loads: restore only
        files you trust).  The host's store-count flag is rebuilt from the
        restored store, so the next frame takes the right branch."""
        with open(path, "rb") as f:
            state = _StateUnpickler(f).load()
        self.init_sequence(state["K"], state["img_h"], state["img_w"])
        seq, dev = self.sequence, self.device

        def on_dev(a):
            return torch.from_numpy(np.array(a)).to(dev)

        seq["store"] = tracker.TrackStore(*[on_dev(a) for a in state["store"]])
        seq["log"] = tracker.FrameLog(*[on_dev(a) for a in state["log"]])
        seq["usable_frames"] = list(state["usable_frames"])
        seq["T_wcs"] = list(state["T_wcs"])
        seq["P_cws"] = list(state["P_cws"])
        seq["history"] = dict(state.get("history", {}))
        seq["frames_in_log"] = int(state.get("frames_in_log", len(seq["usable_frames"])))
        seq["has_tracks"] = int(seq["store"].count) > 0


class _StateUnpickler(pickle.Unpickler):
    """Reads a sequence state of either package: the JAX package's pickled
    TrackStore and FrameLog (NamedTuples of numpy arrays) load as plain
    tuples, so no JAX module is imported."""

    def find_class(self, module, name):
        if module == "odam_tpu.runtime.tracker" and name in ("TrackStore", "FrameLog"):
            return _Fields
        return super().find_class(module, name)


class _Fields(tuple):
    """Stands in for a pickled NamedTuple of the JAX package: pickle rebuilds
    a NamedTuple by calling its class with the field values in order."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)
