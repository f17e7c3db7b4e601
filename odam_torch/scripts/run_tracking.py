"""Heuristic-tracker baseline CLI (counterpart of ``scripts/run_tracking.py``).

    python -m odam_torch.scripts.run_tracking --config_path configs/detr_scan_net.yaml \\
        --scans_root ./data/ScanNet/scans --out_dir ./result/tracking

Runs the detector with the non-learned IoU / point-containment tracker
(:mod:`odam_torch.runtime.heuristic_tracker`) in place of the GNN
associator, with JAX's flags; per scene it writes the pickle
``{"tracks": [...]}`` at ``<out_dir>/<scene>/<scene>``, each track an array
of rows ``[frame, cls, box4, dims3, t_wo3, angle, score]``.

The detector comes from :func:`odam_torch.scripts.run_processor.build_models`
in bfloat16 (the JAX CLI's default dtype) with the attention kernels on.
A frame's detections stay on the device until one packed host copy; the
tracker then runs on the host.  It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import numpy as np
import torch

from .. import config as config_mod
from .. import resolve_device
from ..data import scannet, transforms
from ..utils.metrics import StageTimer
from . import run_processor


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.scripts.run_tracking",
        description="Detector + heuristic tracker baseline on ScanNet scenes (PyTorch port).")
    ap.add_argument("--config_path", default="configs/detr_scan_net.yaml")
    ap.add_argument("--scans_root", default="./data/ScanNet/scans")
    ap.add_argument("--sequences", default=None)
    ap.add_argument("--detector_ckpt", default="./experiments/detector.pth",
                    help="as run_processor's --detector_ckpt")
    ap.add_argument("--detect_threshold", type=float, default=0.6)
    ap.add_argument("--track_threshold", type=float, default=0.6)
    ap.add_argument("--out_dir", default="./result/tracking")
    ap.add_argument("--use_depth", action="store_true",
                    help="use depth maps (frames/depth/*.png) for point matching")
    ap.add_argument("--max_frames", default=None, type=int)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def detect(detr, image: np.ndarray, K: torch.Tensor, img_w: int, img_h: int,
           threshold: float) -> np.ndarray:
    """One normalized [H, W, 3] frame through DETR and the postprocess:
    the [MAX_DETECTIONS, 14] packed detections on the host (one copy), the
    columns valid, class, score, box4 (xyxy pixels), dims3, t_co3 and the
    angle in degrees."""
    from ..models import detr as detr_mod

    dev = K.device
    with torch.no_grad():
        out = detr(torch.from_numpy(image).to(dev)[None])
        dets = detr_mod.postprocess(out, float(img_w), float(img_h), threshold, K)
        packed = torch.cat([dets.valid[0, :, None].float(), dets.classes[0, :, None].float(),
                            dets.scores[0, :, None], dets.boxes[0], dets.dims[0], dets.t_co[0],
                            dets.angle_deg[0, :, None]], dim=1)
    return packed.cpu().numpy()


def detection_dicts(packed: np.ndarray) -> list[dict]:
    """The tracker's detection dicts of the valid packed rows, in slot order."""
    return [{"cls": int(row[1]), "box": row[3:7], "dims": row[7:10], "t_co": row[10:13],
             "score": float(row[2]), "angle": float(row[13]) * np.pi / 180.0}
            for row in packed if row[0] > 0.5]


def track_scene(detr, index, seq_id: str, args) -> tuple[list[np.ndarray], dict]:
    """One scene through the detector and the heuristic tracker, on the
    device that holds ``detr``: (tracks, stats).  ``stats`` holds the
    frames, each tracked frame's host milliseconds (frame read to tracker
    step), the ``StageTimer`` summary of its stages (load: read and resize;
    detect: the models to the host copy; track: the tracker step) and the
    host copies made."""
    from PIL import Image

    from ..runtime.heuristic_tracker import HeuristicTracker

    dev = next(detr.parameters()).device
    K = scannet.read_intrinsic(index.intrinsic_path(seq_id))[:3, :3]
    axis_align = scannet.read_axis_align(index.meta_path(seq_id))
    frames = index.frame_names(seq_id)
    if args.max_frames:
        frames = frames[: args.max_frames]

    first = np.asarray(Image.open(index.image_path(seq_id, frames[0])))
    ih, iw = transforms.target_size(*first.shape[:2])
    K_s = K.copy()
    K_s[0] *= iw / first.shape[1]
    K_s[1] *= ih / first.shape[0]
    K_dev = torch.from_numpy(K_s.astype(np.float32)).to(dev)

    tracker = HeuristicTracker(track_threshold=args.track_threshold)
    timer = StageTimer()
    frame_ms, host_copies = [], 0
    for frame in frames:
        T_cw = scannet.read_extrinsic(index.pose_path(seq_id, frame))
        if np.isnan(T_cw).any():
            continue
        t0 = time.perf_counter()
        T_wc = axis_align @ np.linalg.inv(T_cw)
        with timer.time("load"):
            rgb = np.asarray(Image.open(index.image_path(seq_id, frame)))
            img = transforms.preprocess_image(rgb, ih, iw)
        with timer.time("detect"):
            det_list = detection_dicts(detect(detr, img, K_dev, iw, ih, args.detect_threshold))
        host_copies += 1
        depth = depth_K = img_for_depth = None
        if args.use_depth:
            dpath = os.path.join(args.scans_root, seq_id, "frames", "depth", f"{frame}.png")
            if os.path.exists(dpath):
                depth = np.asarray(Image.open(dpath)).astype(np.float32) / 1000.0
                depth_K = K  # depth shares intrinsics up to resolution scaling
                img_for_depth = rgb
        with timer.time("track"):
            tracker.step(det_list, int(frame), T_wc, img_for_depth, depth, depth_K)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    return tracker.export_tracks(), {"frames": len(frames), "frame_ms": frame_ms,
                                     "stages": timer.summary(), "host_copies": host_copies,
                                     "size": (ih, iw)}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 stays float32 after the model (cuDNN defaults to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = config_mod.merge_cfg([args.config_path])
    detr, _ = run_processor.build_models(cfg, args.detector_ckpt, None, "exact", device,
                                         torch.bfloat16)

    sequences = None
    if args.sequences:
        with open(args.sequences) as f:
            sequences = f.read().splitlines()
    index = scannet.SceneIndex(args.scans_root, sequences)

    for seq_id in index.sequences:
        print(f"tracking: {seq_id}")
        t0 = time.time()
        tracks, stats = track_scene(detr, index, seq_id, args)
        fps = stats["frames"] / max(time.time() - t0, 1e-6)
        print(f"  {stats['frames']} frames, {fps:.1f} fps, {len(tracks)} tracks")

        out_dir = os.path.join(args.out_dir, seq_id)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, seq_id), "wb") as f:
            pickle.dump({"tracks": tracks}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
