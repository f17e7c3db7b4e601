"""Scan2CAD F1 evaluation CLI (counterpart of ``scripts/eval_scan2cad.py``).

    python -m odam_torch.scripts.eval_scan2cad --result_dir ./result/test \\
        --scan2cad ./data/Scan2CAD/full_annotations.json \\
        --scans_root ./data/ScanNet/scans \\
        --val_split ./data/ScanNet/scannetv2_val.txt \\
        --threshold 0.25 --min_views 10

Scores the result pickles of either package's ``run_processor``.  It runs
on the host (NumPy) and needs no card.
"""
from __future__ import annotations

import argparse

from ..eval import scan2cad


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.eval_scan2cad",
                                 description="Per-class Scan2CAD F1 of result pickles.")
    ap.add_argument("--result_dir", required=True)
    ap.add_argument("--scan2cad", default="./data/Scan2CAD/full_annotations.json")
    ap.add_argument("--scans_root", default="./data/ScanNet/scans")
    ap.add_argument("--val_split", default="./data/ScanNet/scannetv2_val.txt")
    ap.add_argument("--threshold", type=float, default=0.25)
    ap.add_argument("--min_views", type=int, default=1)
    ap.add_argument("--vid2cad_csv", default=None,
                    help="score Vid2CAD CSV predictions instead of pickles")
    ap.add_argument("--box2cad", default="./box2cad.json",
                    help="CAD bbox-normalization table for --vid2cad_csv")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    with open(args.val_split) as f:
        sequences = f.read().splitlines()
    return scan2cad.evaluate(
        args.result_dir, args.scan2cad, args.scans_root, sequences,
        threshold=args.threshold, min_views=args.min_views,
        vid2cad_csv=args.vid2cad_csv, box2cad_path=args.box2cad,
    )


if __name__ == "__main__":
    main()
