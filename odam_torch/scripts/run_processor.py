"""End-to-end pipeline CLI: detect -> associate -> map over ScanNet scenes.

    python -m odam_torch.scripts.run_processor --config_path configs/detr_scan_net.yaml \\
        --use_prior --representation super_quadric --out_dir ./result/test

Counterpart of ``scripts/run_processor.py`` with the same flags, defaults
and output: per scene, a pickle ``{tracks, bboxes_qc, bboxes_dl, quadrics}``
of numpy arrays (``quadrics``: SQParams of numpy arrays) at
``<out_dir>/<scene>/<scene>``.  It runs the online mode: the per-frame step,
then ``optim_process``, ``merge_process`` and ``optim_process`` again.

It runs on the card unless ``--device cpu``.  ``--dtype`` defaults to
float32 (bf16 models are not ported yet), and float32 means full float32 on
the card: TF32 is turned off for matmuls and cuDNN convolutions.  The
attention kernels always run on the card, so ``--use_pallas`` has no
counterpart.  Flags that select a path the port does not have yet exit with
code 2 and name their ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import torch

from .. import config as config_mod
from .. import resolve_device
from ..data import loader, scannet, transforms

# flag value -> the ROADMAP item that ports it
UNPORTED = {
    "offline": "--offline needs runtime/offline.py (ROADMAP Queue 1 item 8)",
    "scene_parallel": "--scene_parallel needs runtime/scene_parallel.py (ROADMAP Queue 1 item 9)",
    "solver_lm": "--solver lm needs mapping/lm_solver.py (ROADMAP Queue 1 item 7)",
    "device_resize": "--device_resize needs the on-device resize (ROADMAP Queue 1 item 6)",
    "track_bbox_exact": "--track_bbox exact (implied by --profile fast) needs the closed-form "
                        "quadric bbox, mapping/quadric.py (ROADMAP Queue 1 item 6)",
    "bfloat16": "--dtype bfloat16 needs bf16 models (ROADMAP Queue 1 item 3)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.scripts.run_processor",
        description="Detect, associate and map ScanNet scenes on the card (PyTorch port).")
    ap.add_argument("--config_path", default="configs/detr_scan_net.yaml")
    ap.add_argument("--detect_threshold", default=0.6, type=float)
    ap.add_argument("--min_views", default=10, type=int,
                    help="optimizer view gate: tracks with fewer valid views keep their "
                         "detector-average box (eval twin: eval_scan2cad --min_views)")
    ap.add_argument("--attach_threshold", default=0.8, type=float,
                    help="Sinkhorn attach/new-track score gate")
    ap.add_argument("--robust_init", action="store_true",
                    help="median (vs the reference's mean) track aggregation for the mapping "
                         "init and the detector-average fallback box")
    ap.add_argument("--use_prior", action="store_true")
    ap.add_argument("--no_code", action="store_true")
    ap.add_argument("--representation", default="super_quadric",
                    help="[cube, super_quadric, quadric]")
    ap.add_argument("--out_dir", default="./result/test")
    ap.add_argument("--scans_root", default="./data/ScanNet/scans")
    ap.add_argument("--sequences", default=None,
                    help="file with one scene id per line (default: all scenes)")
    ap.add_argument("--detector_ckpt", default="./experiments/detector.pth",
                    help="Flax tree as .npz (tests/test_torch_checkpoints.py writes them); "
                         "a missing file means seeded weights")
    ap.add_argument("--associator_ckpt", default="./experiments/associator.pth",
                    help="as --detector_ckpt")
    ap.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"],
                    help="float32 (the default here; bfloat16 models are not ported yet, "
                         "ROADMAP Queue 1 item 3)")
    ap.add_argument("--max_frames", default=None, type=int)
    ap.add_argument("--resume", action="store_true",
                    help="skip scenes whose output already exists")
    ap.add_argument("--offline", action="store_true",
                    help="batched-ahead detection + streamed association (not ported yet)")
    ap.add_argument("--detect_batch", type=int, default=8)
    ap.add_argument("--device_resize", action="store_true",
                    help="ship raw uint8 frames and resize on the device (not ported yet)")
    ap.add_argument("--prefetch_workers", type=int, default=2)
    ap.add_argument("--profile", choices=["parity", "fast"], default="parity",
                    help="parity: exact Hungarian + sampled track projection; fast: greedy "
                         "decode + closed-form projection (not ported yet)")
    ap.add_argument("--solver", choices=["adam", "lm"], default="adam",
                    help="mapping solver: adam (lm is not ported yet)")
    ap.add_argument("--decode", choices=["profile", "exact", "greedy"], default="profile",
                    help="association decode (overrides --profile)")
    ap.add_argument("--track_bbox", choices=["profile", "sampled", "exact"], default="profile",
                    help="track re-projection mode (overrides --profile)")
    ap.add_argument("--max_objs", type=int, default=64,
                    help="mapping-stage object-slot capacity")
    ap.add_argument("--max_views", type=int, default=256,
                    help="mapping-stage view-slot capacity per object")
    ap.add_argument("--window", type=int, default=100,
                    help="associator track-history window")
    ap.add_argument("--short_side", type=int, default=800,
                    help="inference resize: shorter side")
    ap.add_argument("--max_size", type=int, default=1333,
                    help="inference resize: longest-side cap")
    ap.add_argument("--shard", default=None,
                    help="'i/n': process scenes i, i+n, i+2n, ...")
    ap.add_argument("--scene_parallel", type=int, default=0,
                    help="one scene per device (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def unported(args, track_bbox: str) -> list[str]:
    """The ROADMAP messages of every selected path the port does not have."""
    picked = {"offline": args.offline, "scene_parallel": bool(args.scene_parallel),
              "solver_lm": args.solver == "lm", "device_resize": args.device_resize,
              "track_bbox_exact": track_bbox == "exact", "bfloat16": args.dtype == "bfloat16"}
    return [UNPORTED[k] for k, on in picked.items() if on]


def load_weights(path: str, what: str) -> dict | None:
    """A Flax tree from ``path`` (.npz), or None (seeded init) when there is no
    such file.  Other formats exit with the ROADMAP item that reads them."""
    from ..models import convert

    if path and os.path.isfile(path) and path.endswith(".npz"):
        print(f"loaded {what} weights from {path}")
        return convert.load_flax_npz(path)
    if path and os.path.isdir(path):
        sys.exit(f"{what} checkpoint {path} is an orbax directory, which the port does not "
                 "read: convert it to .npz (tests/test_torch_checkpoints.py shows how)")
    if path and os.path.exists(path):
        sys.exit(f"{what} checkpoint {path}: reference .pth weights are not ported yet "
                 "(ROADMAP Queue 1 item 1, odam_tpu/models/porting.py)")
    print(f"WARNING: no {what} checkpoint; using random init", file=sys.stderr)
    return None


def build_models(cfg, detector_ckpt: str, associator_ckpt: str, decode: str, device):
    from ..models import associator as assoc_mod
    from ..models import detr as detr_mod

    detr = detr_mod.build_detr(detr_mod.DETRConfig.from_cfg(cfg),
                               flax_params=load_weights(detector_ckpt, "detector"),
                               device=device)
    assoc = assoc_mod.build_associator(
        dataclasses.replace(assoc_mod.AssociatorConfig.from_cfg(cfg), decode=decode),
        flax_params=load_weights(associator_ckpt, "associator"), device=device)
    return detr, assoc


def run_scene(pipe, index, seq_id: str, args) -> tuple[dict, int, int]:
    """Frames -> optim -> merge -> optim for one scene: (result, frames, tracks)."""
    from PIL import Image

    K = scannet.read_intrinsic(index.intrinsic_path(seq_id))[:3, :3]
    axis_align = scannet.read_axis_align(index.meta_path(seq_id))
    frames = index.frame_names(seq_id)
    if args.max_frames:
        frames = frames[: args.max_frames]
    first = np.asarray(Image.open(index.image_path(seq_id, frames[0])))
    ih, iw = transforms.target_size(*first.shape[:2], short_side=args.short_side,
                                    max_size=args.max_size)
    K_scaled = K.copy()
    K_scaled[0] *= iw / first.shape[1]
    K_scaled[1] *= ih / first.shape[0]
    pipe.init_sequence(K_scaled, ih, iw)

    frame_iter = loader.scene_frame_loader(
        index, seq_id, frames, lambda rgb: transforms.preprocess_image(rgb, ih, iw),
        num_workers=args.prefetch_workers)
    usable = (item for item in frame_iter if not np.isnan(item[2]).any())  # NaN poses skipped
    n_frames = 0
    for fid, img, T_cw in loader.device_prefetch(usable, pipe.device):
        pipe.process_frame(img, fid, axis_align @ np.linalg.inv(T_cw))
        n_frames += 1
    n_tracks = len(pipe.tracks)
    out = pipe.optim_process(pipe.tracks)
    out = pipe.optim_process(pipe.merge_process(out))
    return out, n_frames, n_tracks


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    fast = args.profile == "fast"
    decode = args.decode if args.decode != "profile" else ("greedy" if fast else "exact")
    track_bbox = args.track_bbox if args.track_bbox != "profile" else (
        "exact" if fast else "sampled")
    missing = unported(args, track_bbox)
    if missing:
        print("not ported yet:\n  " + "\n  ".join(missing), file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 means float32: cuDNN runs convolutions in TF32 by default
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from ..runtime import processor as proc_mod

    cfg = config_mod.merge_cfg([args.config_path])
    detr, assoc = build_models(cfg, args.detector_ckpt, args.associator_ckpt, decode, device)
    pcfg = proc_mod.PipelineConfig(
        detect_threshold=args.detect_threshold,
        score_threshold=args.attach_threshold,
        representation=args.representation,
        use_prior=args.use_prior,
        no_code=args.no_code,
        optim_solver=args.solver,
        min_views=args.min_views,
        robust_init=args.robust_init,
        max_objs=args.max_objs,
        max_views=args.max_views,
        window=args.window,
    )
    pipe = proc_mod.OdamPipeline(detr, assoc, pcfg, device=device)

    sequences = None
    if args.sequences:
        with open(args.sequences) as f:
            sequences = f.read().splitlines()
    index = scannet.SceneIndex(args.scans_root, sequences)
    scene_list = index.sequences
    if args.shard:
        i, n = (int(x) for x in args.shard.split("/"))
        scene_list = scene_list[i::n]
        print(f"shard {i}/{n}: {len(scene_list)} scenes")

    for seq_id in scene_list:
        out_dir = os.path.join(args.out_dir, seq_id)
        out_path = os.path.join(out_dir, seq_id)
        if args.resume and os.path.exists(out_path):
            print(f"skipping (resume): {seq_id}")
            continue
        print(f"processing: {seq_id}")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        out, n_frames, n_tracks = run_scene(pipe, index, seq_id, args)
        fps = n_frames / max(time.time() - t0, 1e-6)
        print(f"  {n_frames} frames, {fps:.1f} fps, {n_tracks} tracks")
        with open(out_path, "wb") as f:
            pickle.dump({k: out[k] for k in ("tracks", "bboxes_qc", "bboxes_dl", "quadrics")}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
