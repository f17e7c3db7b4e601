"""Dense LM-envelope boundary sweep: refit the auto-router's thresholds.

    python -m odam_torch.scripts.lm_envelope_sweep [--views 48] [--samples 256]

Counterpart of ``scripts/lm_envelope_sweep.py``.  The LM solver's envelope
constants (:mod:`odam_torch.mapping.lm_solver`: ``ENVELOPE_EDGE_FRAC_MIN``,
``ENVELOPE_ASPECT_MIN``) route out-of-envelope objects to the Adam solve.
This solves a grid of edge-keep fraction x aspect ratio x seed, every cell
an object of ONE batched call of each solver (no per-cell loop), and prints
the per-cell IoU delta (LM - Adam, worst over the seeds), the tightest
corners with a 0.02-IoU margin, and the calibration of the residual gate
(``ACCEPT_RESID_MAX``) from both solutions' normalized residuals.  The
solves run on the card unless ``--device cpu``; the first line names the
device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device

EDGE_FRACS = (0.30, 0.40, 0.50, 0.60, 0.70)
ASPECTS = (0.06, 0.09, 0.12, 0.16, 0.20)
SEEDS = (0, 1)


def _look_at(cam, target):
    fwd = target - cam
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, cam
    return T


def build_batch(edge_fracs=EDGE_FRACS, aspects=ASPECTS, seeds=SEEDS, n_views: int = 48,
                noise: float = 1.0, device: str | torch.device | None = None):
    """All grid cells as one object batch: (solver args on ``device``, the
    cells, the ground-truth corners [O, 8, 3]).  ``device`` defaults to the
    card (:func:`odam_torch.resolve_device`)."""
    from ..mapping import superquadric as sq
    from ..utils import geometry as geo

    dev = resolve_device(device)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    center = np.array([0.1, -0.2, 0.8])
    angle = 0.35

    cells = [(e, a, s) for e in edge_fracs for a in aspects for s in seeds]
    O, V = len(cells), n_views
    boxes = np.zeros((O, V, 4), np.float32)
    box_mask = np.zeros((O, V, 4), np.float32)
    P_cw = np.zeros((O, V, 3, 4), np.float32)
    init_t = np.zeros((O, 3), np.float32)
    init_a = np.zeros((O,), np.float32)
    init_d = np.zeros((O, 3), np.float32)
    gts = np.zeros((O, 8, 3))

    def f32(x):   # JAX's corners are float32, as its arrays default to
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    for o, (edge_frac, aspect, seed) in enumerate(cells):
        rng = np.random.default_rng(100 + seed)
        dims = np.array([1.2, 1.05, 1.2 * aspect])
        corners = geo.box3d_corners(f32(dims), f32(angle), f32(center)).numpy()
        gts[o] = corners
        for v in range(V):
            phi = 2 * np.pi * v / V
            cam = center + 3.0 * np.array([np.cos(phi), np.sin(phi), 0.35])
            P = K @ np.linalg.inv(_look_at(cam, center))[:3, :]
            hom = np.concatenate([corners, np.ones((8, 1))], 1)
            uv = hom @ P.T
            uv = uv[:, :2] / uv[:, 2:]
            boxes[o, v] = [uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()]
            boxes[o, v] += rng.normal(0, noise, 4)
            box_mask[o, v] = rng.random(4) < edge_frac
            P_cw[o, v] = P
        init_t[o] = center + [0.3, -0.2, 0.1]
        init_a[o] = angle + 0.15
        init_d[o] = dims * 1.3

    def on(x):
        return torch.from_numpy(x).to(dev)

    init = sq.init_params(on(init_t), on(init_a), on(init_d))
    args = (init, on(boxes), on(box_mask), torch.ones((O, V), device=dev), on(P_cw),
            torch.ones((O,), dtype=torch.bool, device=dev), None)
    return args, cells, gts


def run_sweep(n_views: int = 48, n_samples: int = 256, lm_iters: int = 25,
              adam_iters: int = 150, verbose: bool = True,
              device: str | torch.device | None = None):
    """Both solvers over the grid; returns (rows of (edge_frac, aspect, seed,
    LM IoU, Adam IoU, LM residual, Adam residual), the worst delta a cell,
    the corners within -0.02)."""
    from ..mapping import lm_solver, optimizer
    from ..utils import host_boxes

    args, cells, gts = build_batch(n_views=n_views, device=device)
    lm = lm_solver.optimize_superquadrics_lm(*args, n_iters=lm_iters, n_samples=n_samples,
                                             use_prior=False)
    ad = optimizer.optimize_superquadrics(*args, n_iters=adam_iters, n_samples=n_samples,
                                          use_prior=False)

    # A-posteriori residuals of both solutions: calibrates ACCEPT_RESID_MAX
    # (the Adam residuals are the observation-noise floor a perfect solver
    # pays; the gate must sit above that floor and below failed-LM levels).
    with torch.no_grad():
        lm_resid = lm_solver.normalized_fit_residual(lm.params, *args[1:5],
                                                     n_samples=n_samples).cpu().numpy()
        ad_resid = lm_solver.normalized_fit_residual(ad.params, *args[1:5],
                                                     n_samples=n_samples).cpu().numpy()
    lm_corners = lm.corners.detach().cpu().numpy().astype(np.float64)
    ad_corners = ad.corners.detach().cpu().numpy().astype(np.float64)

    rows = []
    for o, (edge_frac, aspect, seed) in enumerate(cells):
        lm_iou, _ = host_boxes.box3d_iou(lm_corners[o], gts[o])
        ad_iou, _ = host_boxes.box3d_iou(ad_corners[o], gts[o])
        rows.append((edge_frac, aspect, seed, lm_iou, ad_iou,
                     float(lm_resid[o]), float(ad_resid[o])))

    # Aggregate the worst delta per (edge_frac, aspect) cell over seeds.
    agg: dict = {}
    for e, a, s, lm_iou, ad_iou, _, _ in rows:
        d = lm_iou - ad_iou
        agg[(e, a)] = min(agg.get((e, a), np.inf), d)

    efs = sorted({e for e, _ in agg})
    asps = sorted({a for _, a in agg})
    if verbose:
        print("worst-over-seeds IoU delta (LM - Adam); rows=edge_frac, cols=aspect")
        print("        " + "  ".join(f"{a:6.2f}" for a in asps))
        for e in efs:
            print(f"  {e:4.2f}  " + "  ".join(f"{agg[(e, a)]:+6.3f}" for a in asps))

    # Tightest thresholds with a 0.02 margin: smallest (edge_frac, aspect)
    # grid corner such that every cell at or above BOTH is within -0.02.
    ok_corners = []
    for te in efs:
        for ta in asps:
            cells_in = [(e, a) for e, a in agg if e >= te and a >= ta]
            if cells_in and all(agg[c] >= -0.02 for c in cells_in):
                ok_corners.append((te, ta))
    if verbose:
        print("corners with all-in-envelope cells within -0.02:", ok_corners)
        if ok_corners:
            best = min(ok_corners)
            print(f"suggested: ENVELOPE_EDGE_FRAC_MIN ~ {best[0]}, "
                  f"ENVELOPE_ASPECT_MIN ~ {best[1]} (add safety margin)")
        # Residual-gate calibration: separate good LM fits (delta >= -0.02)
        # from failures (delta < -0.05) by the normalized residual alone.
        good = [r[5] for r in rows if r[3] - r[4] >= -0.02]
        bad = [r[5] for r in rows if r[3] - r[4] < -0.05]
        floor = [r[6] for r in rows]
        print(f"normalized residual — Adam floor: max {max(floor):.3f}; "
              f"good-LM: max {max(good) if good else float('nan'):.3f} (n={len(good)}); "
              f"failed-LM: min {min(bad) if bad else float('nan'):.3f} "
              f"(n={len(bad)})")
        if good and bad and max(good) < min(bad):
            print(f"suggested ACCEPT_RESID_MAX in ({max(good):.3f}, {min(bad):.3f})")
    return rows, agg, ok_corners


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.lm_envelope_sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=48)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--lm_iters", type=int, default=25)
    ap.add_argument("--adam_iters", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from ..utils.metrics import device_banner

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {device_banner(dev)}", flush=True)
    return run_sweep(args.views, args.samples, args.lm_iters, args.adam_iters, device=dev)


if __name__ == "__main__":
    main()
