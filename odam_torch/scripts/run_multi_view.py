"""Standalone mapping stage: optimize superquadrics from cached tracks.

Counterpart of ``scripts/run_multi_view.py`` (the reference's
src/scripts/run_multi_view.py), with its flags and output keys:

    python -m odam_torch.scripts.run_multi_view --tracks <pickle-with-tracks> \\
        --scans_root ./data/ScanNet/scans --scene scene0000_00 --out out.pkl

Solves every object of the cached tracks without detection or
association, and writes ``{tracks, bboxes_qc, bboxes_dl, quadrics}``:
``quadrics`` is one SQParams of numpy arrays over the object slots.  As in
JAX, the projections use the scene's unscaled color intrinsics at a fixed
968x1296, the box lists are in the constraints' slot order (longest track
first) while ``tracks`` keeps the input order, and boxes from
``run_tracking`` are in resized pixels (ROADMAP.md, Queue 3).  It runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import pickle
import time

import numpy as np
import torch

from .. import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.scripts.run_multi_view",
        description="Superquadric solve over cached tracks of one scene (PyTorch port).")
    ap.add_argument("--tracks", required=True,
                    help="pickle holding {'tracks': [...]} or a raw track list")
    ap.add_argument("--scans_root", default="./data/ScanNet/scans")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--representation", default="super_quadric")
    ap.add_argument("--use_prior", action="store_true")
    ap.add_argument("--n_iters", type=int, default=200)
    ap.add_argument("--min_views", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Returns the written dict and the solve's seconds under ``"seconds"``."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from ..data import scannet
    from ..mapping import constraints, optimizer, prior
    from ..mapping import superquadric as sq

    with open(args.tracks, "rb") as f:
        data = pickle.load(f)
    tracks = data["tracks"] if isinstance(data, dict) else data

    index = scannet.SceneIndex(args.scans_root, [args.scene])
    K = scannet.read_intrinsic(index.intrinsic_path(args.scene))[:3, :3]
    axis_align = scannet.read_axis_align(index.meta_path(args.scene))
    frames = index.frame_names(args.scene)

    frame_ids, P_cws = [], []
    for frame in frames:
        T_cw = scannet.read_extrinsic(index.pose_path(args.scene, frame))
        if np.isnan(T_cw).any():
            continue
        T_wc = axis_align @ np.linalg.inv(T_cw)
        frame_ids.append(int(frame))
        P_cws.append(K @ np.linalg.inv(T_wc)[:3, :])

    img_h, img_w = 968, 1296  # ScanNet color resolution
    sc = constraints.build_scene_constraints(
        tracks, np.asarray(frame_ids), np.asarray(P_cws), img_h, img_w,
        max_objs=max(len(tracks), 1), max_views=512, min_views=args.min_views,
    )

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    init = sq.init_params(on_dev(sc.init_translate), on_dev(sc.init_angle),
                          on_dev(sc.init_dims), args.representation)
    t0 = time.time()
    res = optimizer.optimize_superquadrics(
        init, on_dev(sc.boxes), on_dev(sc.box_mask), on_dev(sc.view_mask), on_dev(sc.P_cw),
        on_dev(sc.optimize_mask), on_dev(prior.prior_invcov_for_classes(sc.obj_class)),
        n_iters=args.n_iters, representation=args.representation,
        use_prior=args.use_prior,
    )
    corners = res.corners.cpu().numpy()          # waits for the solve
    seconds = time.time() - t0
    print(f"optimized {int(sc.obj_valid.sum())} objects in {seconds:.2f}s")

    out = {
        "tracks": tracks,
        "bboxes_qc": list(corners[: len(tracks)]),
        "bboxes_dl": list(res.corners_detector.cpu().numpy()[: len(tracks)]),
        "quadrics": sq.SQParams(*[leaf.cpu().numpy() for leaf in res.params]),
    }
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    return {**out, "seconds": seconds}


if __name__ == "__main__":
    main()
