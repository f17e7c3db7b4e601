"""Standalone track-merge stage over cached mapping outputs.

Counterpart of ``scripts/run_merge.py`` (the reference's
src/scripts/run_merge.py): cluster the optimized boxes by oriented 3D IoU
and fuse fragmented tracks.  Host NumPy; it needs no card.

    python -m odam_torch.scripts.run_merge --input result/scene0000_00/scene0000_00 \\
        --out merged.pkl
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..mapping import merge


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.run_merge",
                                 description="Fuse fragmented tracks of a mapping output.")
    ap.add_argument("--input", required=True,
                    help="pickle with {tracks, bboxes_qc, ...}")
    ap.add_argument("--out", required=True)
    ap.add_argument("--threshold", type=float, default=merge.MERGE_DISTANCE_THRESHOLD)
    return ap


def main(argv: list[str] | None = None) -> list[np.ndarray]:
    """Returns the merged tracks, as written to ``--out``."""
    args = build_parser().parse_args(argv)
    with open(args.input, "rb") as f:
        data = pickle.load(f)
    frame_ids = np.unique(np.concatenate([t[:, 0] for t in data["tracks"]]))
    merged = merge.merge_tracks(
        data["tracks"], data["bboxes_qc"], frame_ids, args.threshold
    )
    print(f"{len(data['tracks'])} tracks -> {len(merged)} after merge")
    with open(args.out, "wb") as f:
        pickle.dump({"tracks": merged}, f)
    return merged


if __name__ == "__main__":
    main()
