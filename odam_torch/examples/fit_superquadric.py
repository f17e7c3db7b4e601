"""Headless superquadric-fitting demo.

    python -m odam_torch.examples.fit_superquadric [--out_dir OUT] [--iters N] [--device cpu]

Counterpart of ``examples/fit_superquadric.py``, the twin of the reference's
interactive Pangolin demo (learnable_primitives/main.py:18-117): fit a
superquadric (position + axis scales + two shape exponents) to the sampled
surface of a ground-truth superquadric by pointwise L1 on corresponding
surface samples, the reference's objective (size squared for positivity,
shape squashed to [0.2, 1.6]).  The defaults (Adam lr 0.005 x 2000) reach
pointwise L1 ~1e-3; pass ``--lr 0.001 --iters 1000`` for the reference's
schedule.  The optimizer is optax's Adam in optax's arithmetic
(:class:`odam_torch.models.training.OptaxAdam`, no clip).  It writes
headless artifacts: ``gt.obj`` / ``fitted.obj`` (surface meshes) and
``convergence.png`` (point-cloud snapshots at checkpoints and the loss
curve, with matplotlib).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import resolve
from ..models.training import OptaxAdam
from ..ops import sampler, surface

N_SAMPLES = 1000
CHECKPOINTS = 6  # snapshots in the convergence strip
PARAMS = ("size_sqrt", "shape_raw", "pos")


def sample_sq(pos, scales, epsilons, n_samples=N_SAMPLES):
    """Surface samples of one superquadric: [S, 3]."""
    pts, _ = sampler.sample_surface_points(scales[None], epsilons[None], n_samples)
    return pts[0] + pos[None]


def fit(gt_pos, gt_scales, gt_epsilons, n_iters: int = 2000, lr: float = 5e-3,
        device: str = "cuda"):
    """Fit init (unit sphere at origin) to the GT surface samples.

    Returns (GT points, params at the checkpoints, loss log [n_iters], final
    params, checkpoint iterations), numpy, as JAX's.  Parameterization
    matches the reference demo: size stored as sqrt (squared on use), shapes
    squashed by sigmoid to [0.2, 1.6].
    """
    dev = resolve(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    with torch.no_grad():
        gt_pts = sample_sq(t(gt_pos), t(gt_scales), t(gt_epsilons))
    params = {
        "size_sqrt": torch.ones(3, device=dev, requires_grad=True),   # init_size = 1
        "shape_raw": torch.zeros(2, device=dev, requires_grad=True),  # eps = 0.9
        "pos": torch.zeros(3, device=dev, requires_grad=True),
    }
    opt = OptaxAdam({"main": (lr, [((k,), params[k]) for k in PARAMS])}, clip_norm=float("inf"))
    idx = np.linspace(0, n_iters - 1, CHECKPOINTS).round().astype(int)
    losses, snapshots = [], {}
    for i in range(n_iters):
        for p in params.values():
            p.grad = None
        pts = sample_sq(params["pos"], params["size_sqrt"] ** 2,
                        surface.squash_shape(params["shape_raw"]))
        loss = torch.mean(torch.abs(pts - gt_pts))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i in idx:
            snapshots[i] = {k: v.detach().clone() for k, v in params.items()}
    checkpoints = [{k: v.cpu().numpy() for k, v in snapshots[i].items()} for i in idx]
    final = {k: v.detach().cpu().numpy() for k, v in params.items()}
    return (gt_pts.cpu().numpy(), checkpoints, torch.stack(losses).cpu().numpy(), final, idx)


def write_artifacts(out_dir: str, gt_pts, checkpoints, losses, params,
                    ckpt_iters, gt) -> dict:
    """Write gt.obj / fitted.obj / convergence.png; returns artifact paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..mapping import superquadric as sq
    from ..utils import visualization as viz

    os.makedirs(out_dir, exist_ok=True)
    gt_pos, gt_scales, gt_epsilons = gt

    def squash(raw):
        return surface.squash_shape(torch.as_tensor(np.asarray(raw), dtype=torch.float32)).numpy()

    def params_to_sq(pos, scales, epsilons):
        # SQParams stores scales as sqrt(dims/2) and raw (pre-squash)
        # shapes; invert the demo parameterization into that contract.
        eps = np.clip(np.asarray(epsilons), 0.2001, 1.5999)
        raw = np.log((eps - 0.2) / (1.6 - eps))  # inverse sigmoid squash
        return sq.SQParams(
            translate=np.asarray(pos, np.float32),
            angle=np.asarray(0.0, np.float32),
            scales=np.sqrt(np.asarray(scales)).astype(np.float32),
            shapes=np.asarray(raw, np.float32),
        )

    paths = {}
    fitted_scales = np.asarray(params["size_sqrt"]) ** 2
    fitted_eps = squash(params["shape_raw"])
    for name, (pos, scales, eps) in {
        "gt": (gt_pos, gt_scales, gt_epsilons),
        "fitted": (np.asarray(params["pos"]), fitted_scales, fitted_eps),
    }.items():
        verts, faces = viz.sq_surface_mesh(params_to_sq(pos, scales, eps))
        path = os.path.join(out_dir, f"{name}.obj")
        viz.export_obj(path, verts, faces)
        paths[name] = path

    fig, axes = plt.subplots(1, len(checkpoints) + 1,
                             figsize=(3 * (len(checkpoints) + 1), 3))
    for ax, p, it in zip(axes[:-1], checkpoints, ckpt_iters):
        scales = np.asarray(p["size_sqrt"]) ** 2
        with torch.no_grad():
            pts = sample_sq(torch.as_tensor(p["pos"]), torch.as_tensor(scales),
                            torch.as_tensor(squash(p["shape_raw"]))).numpy()
        ax.scatter(gt_pts[:, 0], gt_pts[:, 2], s=2, c="tab:red", alpha=0.4, label="GT")
        ax.scatter(pts[:, 0], pts[:, 2], s=2, c="tab:green", alpha=0.4, label="fit")
        ax.set_title(f"iter {it}")
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
    axes[0].legend(loc="upper left", fontsize=7)
    axes[-1].plot(losses)
    axes[-1].set_yscale("log")
    axes[-1].set_title("L1 loss")
    strip = os.path.join(out_dir, "convergence.png")
    fig.tight_layout()
    fig.savefig(strip, dpi=110)
    plt.close(fig)
    paths["strip"] = strip
    return paths


def ground_truth(seed: int = 0):
    """(pos, scales, epsilons) of the seed's ground-truth superquadric."""
    rng = np.random.default_rng(seed)
    gt_pos = rng.uniform(-2, 2, 3).astype(np.float32)
    gt_scales = rng.uniform(0.4, 2.0, 3).astype(np.float32)
    gt_epsilons = rng.uniform(0.3, 1.5, 2).astype(np.float32)
    return gt_pos, gt_scales, gt_epsilons


def main(out_dir: str = "result/fit_superquadric", n_iters: int = 2000,
         seed: int = 0, lr: float = 5e-3, verbose: bool = True, device: str = "cuda") -> dict:
    gt_pos, gt_scales, gt_epsilons = ground_truth(seed)
    gt_pts, checkpoints, losses, params, ckpt_iters = fit(
        gt_pos, gt_scales, gt_epsilons, n_iters, lr, device
    )
    paths = write_artifacts(
        out_dir, gt_pts, checkpoints, losses, params, ckpt_iters,
        (gt_pos, gt_scales, gt_epsilons),
    )
    result = {
        "loss_first": float(losses[0]),
        "loss_final": float(losses[-1]),
        "pos_err": float(np.linalg.norm(np.asarray(params["pos"]) - gt_pos)),
        "scale_err": float(np.max(np.abs(np.asarray(params["size_sqrt"]) ** 2 - gt_scales))),
        "paths": paths,
    }
    if verbose:
        print(f"GT pos {gt_pos}, scales {gt_scales}, eps {gt_epsilons}")
        print(f"loss {result['loss_first']:.4f} -> {result['loss_final']:.4f}")
        print(f"pos err {result['pos_err']:.4f}, max scale err {result['scale_err']:.4f}")
        print(f"artifacts: {paths}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.fit_superquadric",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default="result/fit_superquadric")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.out_dir, args.iters, args.seed, args.lr, device=args.device)
