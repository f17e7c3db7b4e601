"""Evaluate the segment-trained detector through the full pipeline.

    python -m odam_torch.examples.closed_loop.segment_eval [ckpt] [--device cpu]

Counterpart of ``examples/closed_loop/segment_eval.py`` (which reads
``closed_loop_ckpt``, the default here too): the held-out view's
detections, then :class:`odam_torch.runtime.processor.OdamPipeline` over 24
ring frames with a class-keyed oracle associator, then ``optim_process``,
``merge_process``, ``optim_process``, and each mapped box's oriented-3D IoU
against ground truth.  The detector runs with the attention kernels.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn

from .. import resolve
from ...models import detr as detr_mod
from ...models.associator import AssociatorOutput
from ...runtime import processor as proc_mod
from ...utils import checkpoint, host_boxes
from .closed_scene import IMG, K, OBJECTS, box_corners, make_detr, norm, render, ring_pose

HELD_OUT_PHI = 0.31
N_FRAMES = 24
PIPELINE = dict(detect_threshold=0.6, score_threshold=0.8, max_tracks=8, max_dets=8, window=16,
                track_bbox_samples=128, optim_iters=200, optim_samples=400, min_views=5,
                max_objs=8, max_views=32, max_log_frames=64)
IOU_HIT = 0.25


class ClassOracle(nn.Module):
    """Class-keyed oracle associator (the loop's objects have unique
    classes): a detection matches the first active track whose mean class
    is within 0.5 of its own.  Called as the pipeline calls the associator,
    it returns an :class:`AssociatorOutput` with log assignment 0 at each
    match (the dustbin row for the unmatched) and -20 elsewhere."""

    def forward(self, tracks79, track_mask, det79, det_mask, thr=None) -> AssociatorOutput:
        t = tracks79[0]
        w = (t[..., 0] >= 0).float()
        t_cls = torch.sum(t[..., 1] * w, dim=1) / torch.clamp(w.sum(1), min=1)
        d_cls = det79[0][:, 1]
        ok = ((t_cls[:, None] - d_cls[None, :]).abs() < 0.5) & track_mask[0][:, None] \
            & det_mask[0][None, :]
        T, N = ok.shape
        # argmax of the bools: the first track that claims the detection
        first = torch.argmax(ok.to(torch.int32), dim=0)
        match = torch.where(ok.any(0) & det_mask[0], first, -1)
        Z = torch.full((T + 1, N + 1), -20.0, device=t.device)
        Z[T, :] = 0.0
        Z[torch.where(match >= 0, match, T), torch.arange(N, device=t.device)] = 0.0
        return AssociatorOutput(Z[None], ok[None].float(), match[None].int())


def held_out(model: detr_mod.DETR) -> tuple[detr_mod.Detections, np.ndarray]:
    """The held-out view's detections (numpy fields) and its ground-truth rows."""
    dev = next(model.parameters()).device
    img, gt = render(ring_pose(HELD_OUT_PHI))
    with torch.no_grad():
        out = model(torch.from_numpy(norm(img))[None].to(dev))
        dets = detr_mod.postprocess(out, float(IMG), float(IMG), 0.6,
                                    torch.from_numpy(K).to(dev), max_dets=8)
    return detr_mod.Detections(*[x.cpu().numpy() for x in dets]), gt


def run_pipeline(model: detr_mod.DETR, n_frames: int = N_FRAMES) -> proc_mod.OdamPipeline:
    """The pipeline over the first ``n_frames`` of the 24 half-step ring frames."""
    dev = next(model.parameters()).device
    pipe = proc_mod.OdamPipeline(model, ClassOracle(), proc_mod.PipelineConfig(**PIPELINE),
                                 device=dev)
    pipe.init_sequence(K, IMG, IMG)
    for k in range(n_frames):
        T_wc = ring_pose(2 * np.pi * (k + 0.5) / 24)
        img, _ = render(T_wc)
        pipe.process_frame(norm(img).astype(np.float32), k, T_wc)
    return pipe


def segment_eval(ckpt: str = "closed_loop_ckpt", device: str = "cuda",
                 verbose: bool = True) -> dict:
    dev = resolve(device)
    params, _, meta = checkpoint.restore(ckpt)
    model = detr_mod.build_detr(make_detr(), flax_params=params, device=dev)

    dets, gt = held_out(model)
    v = dets.valid[0]
    result = {"global_step": meta.get("global_step"),
              "held_out": {"n_detections": int(v.sum()), "n_gt": len(gt),
                           "classes": dets.classes[0][v].tolist(),
                           "gt_classes": gt[:, 0].astype(int).tolist(),
                           "scores": dets.scores[0][v].tolist(),
                           "t_co": dets.t_co[0][v].tolist()}}
    if verbose:
        print(f"held-out: {v.sum()} detections (gt {len(gt)}); classes",
              dets.classes[0][v], "gt", gt[:, 0].astype(int))
        print("scores:", np.round(dets.scores[0][v], 2))
        print("t_co:", np.round(dets.t_co[0][v], 2))

    pipe = run_pipeline(model)
    tracks = pipe.tracks
    result["track_lengths"] = [len(t) for t in tracks]
    if verbose:
        print(f"pipeline: {len(tracks)} tracks, lengths {result['track_lengths']}")
    out = pipe.optim_process(tracks)
    merged = pipe.merge_process(out)
    out = pipe.optim_process(merged)
    tp, ious = 0, {}
    for track, corners in zip(out["tracks"], out["bboxes_qc"]):
        cls = int(np.median(track[:, 1]))
        m = [o for o in OBJECTS if o[3] == cls]
        if not m:
            continue
        c, dims, yaw, _, _ = m[0]
        iou, _ = host_boxes.box3d_iou(np.asarray(corners, np.float64), box_corners(dims, yaw, c))
        ious[cls] = iou
        if verbose:
            print(f"  class {cls}: mapped-box IoU vs GT = {iou:.3f}")
        if iou > IOU_HIT:
            tp += 1
    result.update(iou_by_class=ious, objects_hit=tp, n_objects=len(OBJECTS))
    if verbose:
        print(f"CLOSED LOOP RESULT: {tp}/{len(OBJECTS)} objects at oriented-3D-IoU > {IOU_HIT}")
    return result


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.closed_loop.segment_eval",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", nargs="?", default="closed_loop_ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return segment_eval(args.ckpt, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
