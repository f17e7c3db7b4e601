"""The plain reference of a scene end: constraints, the Adam solve and the
merge, as ``odam_torch/runtime/processor.py``'s ``OdamPipeline.optim_process``
and ``merge_process`` chain them (a copy of that glue over the copied
mapping modules).  It imports nothing of ``odam_torch``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import constraints, merge, optimizer, prior
from . import superquadric as sq


def optim_process(tracks: list[np.ndarray], frame_ids, P_cws, img_h: float, img_w: float,
                  pipeline: dict, device, n_iters: int | None = None) -> dict:
    """The solve over a scene's tracks: {tracks, bboxes_qc, loss_log,
    quadrics, optimized, boxes_det}, the tracks kept in input order;
    ``quadrics`` are a kept track's parameters at the end, ``optimized``
    says whether the solve fits its object, ``boxes_det`` is its
    detector-average box.  ``n_iters`` cuts the solve short."""
    sc = constraints.build_scene_constraints(
        tracks, np.asarray(frame_ids), np.asarray(P_cws), img_h, img_w,
        int(pipeline["max_objs"]), int(pipeline["max_views"]), int(pipeline["min_views"]),
        robust_init=bool(pipeline["robust_init"]))

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    init = sq.init_params(on_dev(sc.init_translate), on_dev(sc.init_angle),
                          on_dev(sc.init_dims), pipeline["representation"])
    res = optimizer.optimize_superquadrics(
        init, on_dev(sc.boxes), on_dev(sc.box_mask), on_dev(sc.view_mask), on_dev(sc.P_cw),
        on_dev(sc.optimize_mask), on_dev(prior.prior_invcov_for_classes(sc.obj_class)),
        n_iters=int(pipeline["optim_iters"]) if n_iters is None else n_iters,
        n_samples=int(pipeline["optim_samples"]), representation=pipeline["representation"],
        use_prior=bool(pipeline["use_prior"]))
    corners, loss_log = res.corners.cpu().numpy(), res.loss_log.cpu().numpy()
    n_objs = int(sc.obj_valid.sum())
    order = np.argsort([-len(t) for t in tracks], kind="stable")[: sc.boxes.shape[0]]
    inv = {int(t): s for s, t in enumerate(order)}
    corners_det, optimize = res.corners_detector.cpu().numpy(), np.asarray(sc.optimize_mask)
    params = [t.detach().cpu().numpy() for t in res.params]
    out = {"tracks": [], "bboxes_qc": [], "loss_log": loss_log, "optimized": [],
           "boxes_det": [], "quadrics": []}
    for t_idx in range(len(tracks)):
        if t_idx not in inv or inv[t_idx] >= n_objs:
            continue
        out["tracks"].append(tracks[t_idx])
        out["bboxes_qc"].append(corners[inv[t_idx]])
        out["optimized"].append(bool(optimize[inv[t_idx]]))
        out["boxes_det"].append(corners_det[inv[t_idx]])
        out["quadrics"].append(tuple(leaf[inv[t_idx]] for leaf in params))
    return out


def boxes_of(quadrics: list, optimized: list[bool], boxes_det: list[np.ndarray],
             n_samples: int, device) -> np.ndarray:
    """The boxes that a solve's end makes of its parameters ``quadrics``
    (one (translate, angle, scales, shapes) a kept track): the oriented box
    of each sampled surface, or the detector-average box where the solve
    does not fit the object.  [n, 8, 3]."""
    if not quadrics:
        return np.zeros((0, 8, 3), np.float32)
    leaves = [torch.from_numpy(np.stack([np.asarray(q[i], np.float32) for q in quadrics]))
              .to(device) for i in range(4)]
    corners = sq.oriented_box_corners(sq.SQParams(*leaves), n_samples).cpu().numpy()
    return np.where(np.asarray(optimized)[:, None, None], corners, np.stack(boxes_det))


def merge_process(data: dict, frame_ids) -> list[np.ndarray]:
    return merge.merge_tracks(data["tracks"], data["bboxes_qc"], np.asarray(frame_ids))
