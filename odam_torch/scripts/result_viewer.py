"""Inspect mapping results: export superquadric meshes / view interactively.

Counterpart of ``scripts/result_viewer.py`` (the reference's
src/viewers/result_viewer.py).  Without Open3D installed, exports a
Wavefront OBJ instead of opening a window.  Host only; it needs no card.

    python -m odam_torch.scripts.result_viewer --input result/scene0000_00/scene0000_00 \
        --obj_out scene.obj
"""
from __future__ import annotations

import argparse
import os
import pickle

from ..utils import visualization as viz


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.result_viewer",
                                 description="Superquadric meshes of a result pickle.")
    ap.add_argument("--input", required=True, help="run_processor output pickle")
    ap.add_argument("--obj_out", default=None, help="write OBJ mesh here")
    ap.add_argument("--scene_mesh", default=None, help="optional scene mesh to overlay")
    ap.add_argument("--grid", type=int, default=32)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    with open(args.input, "rb") as f:
        data = pickle.load(f)
    quadrics = [q for q in data.get("quadrics", []) if q is not None]
    print(f"{len(quadrics)} objects")

    if args.obj_out:
        viz.export_scene_obj(args.obj_out, quadrics, grid=args.grid)
        print(f"wrote {args.obj_out}")
        return
    try:
        viz.view_scene_open3d(quadrics, args.scene_mesh)
    except ImportError:
        out = os.path.splitext(args.input)[0] + ".obj"
        viz.export_scene_obj(out, quadrics, grid=args.grid)
        print(f"open3d unavailable; wrote {out}")


if __name__ == "__main__":
    main()
