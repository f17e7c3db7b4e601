"""The plain reference of one lane step's tracking: detection rows, track
re-projection, association and the track-store update, one lane at a time.

Copies of ``odam_torch/runtime/tracker.py``'s store arithmetic
(``TrackStore``, ``mean_state``, ``scatter_drop``, ``append_rows``,
``assign_new_slots``) and of ``odam_torch/runtime/processor.py``'s
one-scene step functions (``detection_rows_camera``,
``lift_rows_to_world``, ``prepare_track_inputs`` in its sampled
mode, ``_attach``, ``_spawn``, ``_attached_ids``), run per lane with a
Python loop where the port vmaps.  It imports nothing of ``odam_torch``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import boxes as box_ops
from . import geometry as geo
from . import superquadric as sq
from .detector import Detections, decode, gather, select

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class TrackStore(NamedTuple):
    window: torch.Tensor
    length: torch.Tensor
    n_obs: torch.Tensor
    sum_t: torch.Tensor
    sum_azi: torch.Tensor
    sum_dims: torch.Tensor
    active: torch.Tensor
    count: torch.Tensor
    track_id: torch.Tensor
    last_frame: torch.Tensor
    next_id: torch.Tensor
    n_evicted: torch.Tensor
    n_dropped: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.window.shape[0]

    @property
    def window_size(self) -> int:
        return self.window.shape[1]


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [..., H, W, 3] -> ImageNet-normalized float32."""
    dev = images_u8.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    return (images_u8.float() / 255.0 - mean) / std


def mean_state(store: TrackStore):
    n = torch.clamp(store.n_obs, min=1).to(store.sum_t.dtype)
    return (store.sum_t / n[:, None], store.sum_azi / n,
            torch.clamp(store.sum_dims / n[:, None], min=0.05))


def scatter_drop(base, index, values):
    pad = torch.cat([base, base[:1]], dim=0)
    return pad.index_put((index,), values.to(base.dtype))[:-1]


def append_rows(store: TrackStore, rows, slots, valid) -> TrackStore:
    T, W = store.capacity, store.window_size
    N = rows.shape[0]
    s = torch.clamp(slots.long(), 0, T - 1)
    dst = torch.where(valid, s, T)
    cur = store.window[s]
    full = store.length[s] >= W
    shifted = torch.where(full[:, None, None], torch.roll(cur, -1, dims=1), cur)
    pos = torch.clamp(store.length[s].long(), max=W - 1)
    shifted[torch.arange(N, device=rows.device), pos] = rows
    inc = torch.where(full, 0, 1).to(torch.int32)
    active = scatter_drop(store.active, dst, torch.ones_like(valid))
    return store._replace(
        window=scatter_drop(store.window, dst, shifted),
        length=scatter_drop(store.length, dst, store.length[s] + inc),
        n_obs=scatter_drop(store.n_obs, dst, store.n_obs[s] + 1),
        sum_t=scatter_drop(store.sum_t, dst, store.sum_t[s] + rows[:, 9:12]),
        sum_azi=scatter_drop(store.sum_azi, dst, store.sum_azi[s] + rows[:, 12]),
        sum_dims=scatter_drop(store.sum_dims, dst, store.sum_dims[s] + rows[:, 6:9]),
        active=active,
        last_frame=scatter_drop(store.last_frame, dst, rows[:, 0]),
        count=active.sum().to(torch.int32),
    )


def assign_new_slots(store: TrackStore, is_new, protected=None):
    T = store.capacity
    dev = store.window.device
    if protected is None:
        protected = torch.zeros(T, dtype=torch.bool, device=dev)
    free = ~store.active
    evictable = store.active & ~protected
    idx = torch.arange(T, dtype=torch.int64, device=dev)
    lru_key = torch.where(evictable, store.last_frame, torch.inf)
    lru_rank = torch.argsort(torch.argsort(lru_key, stable=True), stable=True)
    key = torch.where(free, idx, torch.where(evictable, T + lru_rank, 2 * T + idx))
    order = torch.argsort(key, stable=True)
    n_assignable = free.sum() + evictable.sum()
    rank = torch.cumsum(is_new.long(), dim=0) - 1
    cand = order[torch.clamp(rank, 0, T - 1)]
    ok = is_new & (rank < n_assignable) & (rank < T)
    slots = torch.where(ok, cand, -1).to(torch.int32)
    scatter_to = torch.where(ok, cand, T)
    taken = scatter_drop(torch.zeros(T, dtype=torch.bool, device=dev), scatter_to,
                         torch.ones_like(ok))
    new_ids = (store.next_id + rank).to(torch.int32)
    slot_ids = scatter_drop(torch.full((T,), -1, dtype=torch.int32, device=dev), scatter_to,
                            new_ids)
    evicted = taken & store.active
    i32 = torch.int32
    store = store._replace(
        window=torch.where(taken[:, None, None], -1.0, store.window),
        length=torch.where(taken, 0, store.length).to(i32),
        n_obs=torch.where(taken, 0, store.n_obs).to(i32),
        sum_t=torch.where(taken[:, None], 0.0, store.sum_t),
        sum_azi=torch.where(taken, 0.0, store.sum_azi),
        sum_dims=torch.where(taken[:, None], 0.0, store.sum_dims),
        active=store.active & ~taken,
        count=(store.active & ~taken).sum().to(i32),
        track_id=torch.where(taken, slot_ids, store.track_id),
        last_frame=torch.where(taken, -1.0, store.last_frame),
        next_id=(store.next_id + ok.sum()).to(i32),
        n_evicted=(store.n_evicted + evicted.sum()).to(i32),
        n_dropped=(store.n_dropped + (is_new & ~ok).sum()).to(i32),
    )
    return store, slots


def detection_rows_camera(dets: Detections, b: int, frame_id: float, img_w: float,
                          img_h: float) -> torch.Tensor:
    """Image ``b``'s 79-dim camera-frame rows; invalid slots are -1."""
    N = dets.valid.shape[1]
    dev = dets.valid.device
    angle_rad = dets.angle_deg[b] * (math.pi / 180.0)
    rows = torch.cat([
        torch.full((N, 1), float(frame_id), device=dev),
        dets.classes[b][:, None].float(),
        dets.boxes[b] / box_ops.xyxy_scale(img_w, img_h, dev),
        dets.dims[b], dets.t_co[b],
        torch.sin(angle_rad)[:, None], torch.cos(angle_rad)[:, None],
        dets.scores[b][:, None],
        torch.full((N, 64), -1.0, device=dev),
    ], dim=-1)
    return torch.where(dets.valid[b][:, None], rows, -1.0)


def lift_rows_to_world(det79, det_valid, T_wc, img_w, img_h, no_code: bool = True):
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


def prepare_track_inputs(store: TrackStore, T_wc, K, img_w, img_h, n_samples: int,
                         mode: str) -> torch.Tensor:
    """[T, W, 79] associator input: each track's box re-projected from its
    mean state (sampled superquadric surface; ``exact`` is not referenced)."""
    T_cap, W, _ = store.window.shape
    dev = store.window.device
    if mode != "sampled":
        raise ValueError(f"the reference has no track_bbox_mode {mode!r}")
    t_mean, azi_mean, dims_mean = mean_state(store)
    T_cw = geo.invert_se3(T_wc)
    params = sq.SQParams(translate=t_mean, angle=azi_mean, scales=torch.sqrt(dims_mean / 2.0),
                         shapes=torch.zeros((T_cap, 2), dtype=t_mean.dtype, device=dev))
    pts_c = geo.transform_points(T_cw, sq.surface_points_world(params, n_samples))
    pix = torch.einsum("ij,tsj->tsi", K, pts_c)
    uv = pix[..., :2] / pix[..., 2:]
    box = torch.cat([uv.amin(dim=1), uv.amax(dim=1)], dim=-1)
    box_n = torch.clamp(box / box_ops.xyxy_scale(img_w, img_h, dev), -1.0, 2.0)
    win = store.window
    cam_azi = geo.camera_azimuth(T_wc)
    t_co = geo.transform_points(T_cw, win[..., 9:12].reshape(T_cap * W, 3)).reshape(T_cap, W, 3)
    ang = win[..., 12] - cam_azi
    out = torch.cat([win[..., 0:2], box_n[:, None, :].expand(T_cap, W, 4), win[..., 6:9], t_co,
                     torch.sin(ang)[..., None], torch.cos(ang)[..., None], win[..., 13:14],
                     win[..., 14:78]], dim=-1)
    slot_valid = ((torch.arange(W, device=dev)[None, :] < store.length[:, None])
                  & store.active[:, None])
    return torch.where(slot_valid[..., None], out, -1.0)


def attach(score_threshold: float, store: TrackStore, Z, match, det_valid):
    T_cap = store.capacity
    dev = Z.device
    match = match.long()
    matched = match >= 0
    gate_row = torch.where(matched, match, T_cap)
    gate = torch.exp(Z[gate_row, torch.arange(match.shape[0], device=dev)])
    attach_ok = det_valid & (gate >= score_threshold)
    is_new = attach_ok & ~matched
    matched_mask = scatter_drop(torch.zeros(T_cap, dtype=torch.bool, device=dev), gate_row,
                                torch.ones_like(matched))
    store, new_slots = assign_new_slots(store, is_new, protected=matched_mask)
    slots = torch.where(matched, match.int(), new_slots)
    return store, slots, attach_ok & (slots >= 0)


def spawn(store: TrackStore, det_valid):
    store, slots = assign_new_slots(store, det_valid)
    return store, slots, det_valid & (slots >= 0)


def attached_ids(store: TrackStore, slots, ok):
    T_cap = store.capacity
    return torch.where(ok, store.track_id[torch.clamp(slots.long(), 0, T_cap - 1)], -1)


class StepRecord(NamedTuple):
    """What one lane step produced, lane-stacked: the detector's heads, the
    logged rows and ids, each lane's store after the step, and the
    association's inputs and outputs."""
    heads: dict                # name -> [P, Q, ...] float32
    det_valid: torch.Tensor    # [P, N]
    rows: torch.Tensor         # [P, N, 82] the logged world-frame rows
    ids: torch.Tensor          # [P, N] the track id each row was logged under, -1 none
    stores: list               # P TrackStores after the step
    tracks79: torch.Tensor     # [P, T, W, 79] the associator's track input
    active: torch.Tensor       # [P, T]
    det79: torch.Tensor        # [P, N, 79] its detection input
    log_assignment: torch.Tensor   # [P, T+1, N+1]
    matches: torch.Tensor      # [P, N] track slot per detection, -1 unmatched


HEADS = ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size", "pred_depth",
         "pred_obj_features")


def detector_heads(detr, images_u8: torch.Tensor, block: int) -> dict:
    """The detector's heads on uint8 frames [P, H, W, 3], ``block`` frames a call."""
    outs = [detr(normalize(images_u8[b0:b0 + block])) for b0 in range(0, len(images_u8), block)]
    return {k: torch.cat([o[k] for o in outs]) for k in HEADS}


def rows_for(dets: Detections, frame_ids: list[float], T_wcs: torch.Tensor, img_w: float,
             img_h: float, no_code: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's detections -> (camera rows [P, N, 79], world rows [P, N, 82])."""
    P = dets.valid.shape[0]
    det79 = torch.stack([detection_rows_camera(dets, p, frame_ids[p], img_w, img_h)
                         for p in range(P)])
    det82 = torch.stack([lift_rows_to_world(det79[p], dets.valid[p], T_wcs[p], img_w, img_h,
                                            no_code) for p in range(P)])
    return det79, det82


def update(score_threshold: float, store: TrackStore, Z, matches, det_valid, det82):
    """One lane's store after its detections are attached (association
    branch) or spawned (empty store): (store, logged ids)."""
    if int(store.count) > 0:
        store, slots, ok = attach(score_threshold, store, Z, matches, det_valid)
    else:
        store, slots, ok = spawn(store, det_valid)
    store = append_rows(store, det82, slots, ok)
    return store, attached_ids(store, slots, ok)


def lane_step(pipeline: dict, detr, associator, stores: list[TrackStore],
              images_u8: torch.Tensor, frame_ids: list[float], T_wcs: torch.Tensor,
              Ks: torch.Tensor, img_w: float, img_h: float, block: int = 4) -> StepRecord:
    """One step of P lanes, from each lane's store before it."""
    P = images_u8.shape[0]
    with torch.no_grad():
        heads = detector_heads(detr, images_u8, block)
        cand = decode(heads, img_w, img_h, Ks)
        order, valid = select(cand, float(pipeline["detect_threshold"]),
                              int(pipeline["max_dets"]))
        det79, det82 = rows_for(gather(cand, order, valid), frame_ids, T_wcs, img_w, img_h,
                                bool(pipeline["no_code"]))
        tracks79 = torch.stack([prepare_track_inputs(
            stores[p], T_wcs[p], Ks[p], img_w, img_h, int(pipeline["track_bbox_samples"]),
            pipeline["track_bbox_mode"]) for p in range(P)])
        active = torch.stack([s.active for s in stores])
        out = associator(tracks79, active, det79, valid, float(pipeline["match_threshold"]))
        after, ids = zip(*[update(float(pipeline["score_threshold"]), stores[p],
                                  out.log_assignment[p], out.matches[p], valid[p], det82[p])
                           for p in range(P)])
    return StepRecord(heads=heads, det_valid=valid, rows=det82,
                      ids=torch.stack(ids), stores=list(after), tracks79=tracks79,
                      active=active, det79=det79, log_assignment=out.log_assignment,
                      matches=out.matches)
