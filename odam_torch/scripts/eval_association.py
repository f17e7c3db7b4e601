"""Offline associator evaluation CLI (counterpart of ``scripts/eval_association.py``).

    python -m odam_torch.scripts.eval_association --tracks_dir track_pickles \\
        --ckpt runs/assoc/ckpt_5000 [--associator_pth experiments/associator.pth]

Replays ground-truth track pickles through a trained associator and reports
matching precision / recall / F1 per scene and in total, in JAX's format.
``--ckpt`` is a checkpoint directory of the port's train scripts or a Flax
tree as ``.npz``; ``--associator_pth`` a reference ``.pth`` (unpickled: load
only trusted files).  The associator keeps the attention kernels on, so its
GNN at batch 1 launches ``fused_attention``; JAX's CLI ran the plain
attention there (ROADMAP.md, Queue 3), the same function within the
kernels' bars.  It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys

from .. import config as config_mod
from .. import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.scripts.eval_association",
        description="Associator precision / recall / F1 on ground-truth track pickles.")
    ap.add_argument("--config_path", default="configs/detr_scan_net.yaml")
    ap.add_argument("--tracks_dir", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint directory of the port's train scripts, or a .npz")
    ap.add_argument("--associator_pth", default=None, help="torch checkpoint")
    ap.add_argument("--match_threshold", type=float, default=0.1)
    ap.add_argument("--max_tracks", type=int, default=64)
    ap.add_argument("--max_dets", type=int, default=30)
    ap.add_argument("--window", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Returns ``{pickle name: AssociationMetrics, ..., "TOTAL": totals}``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from ..eval import association
    from ..models import associator as assoc_mod
    from ..models import porting
    from .run_processor import load_weights

    cfg = config_mod.merge_cfg([args.config_path])
    acfg = assoc_mod.AssociatorConfig.from_cfg(cfg)
    path = args.associator_pth or args.ckpt
    if not path:
        sys.exit("need --ckpt or --associator_pth")
    if not os.path.exists(path):
        sys.exit(f"no such checkpoint: {path}")
    params = load_weights(path, "associator", lambda sd: porting.convert_associator(
        sd, d_model=acfg.descriptor_dim, num_heads=acfg.num_heads,
        n_gnn=len(acfg.gnn_layers), n_fuser=len(acfg.self_gnn_layers)))
    model = assoc_mod.build_associator(acfg, flax_params=params, device=device)

    results = {}
    totals = association.AssociationMetrics()
    for fn in sorted(os.listdir(args.tracks_dir)):
        with open(os.path.join(args.tracks_dir, fn), "rb") as f:
            data = pickle.load(f)
        tracks = data["tracks"] if isinstance(data, dict) else data
        m = association.evaluate_scene(
            model, tracks, args.match_threshold,
            args.max_tracks, args.max_dets, args.window,
        )
        print(f"{fn}: P {m.precision:.3f} R {m.recall:.3f} F1 {m.f1:.3f} "
              f"({m.n_frames} frames)")
        results[fn] = m
        totals.n_correct += m.n_correct
        totals.n_pred_matched += m.n_pred_matched
        totals.n_gt_matched += m.n_gt_matched
        totals.n_frames += m.n_frames
    print(f"TOTAL: P {totals.precision:.3f} R {totals.recall:.3f} "
          f"F1 {totals.f1:.3f} ({totals.n_frames} frames)")
    results["TOTAL"] = totals
    return results


if __name__ == "__main__":
    main()
