"""Write the synthetic val split to disk in the exact ScanNet + Scan2CAD
layout the run_processor / eval_scan2cad CLIs consume.

    python -m odam_torch.examples.cli_rehearsal.make_dataset <out_root> [--hard | --tune | --long]

Counterpart of ``examples/cli_rehearsal/make_dataset.py``, writing the same
files.  One departure, on purpose: the output root is required, and a root
inside this repository must lie under ``runs/``, ``chiprun_out/`` or
``result/`` (all ignored by git), so the port never overwrites the
committed splits (``examples/cli_rehearsal/data``, ``data_hard``).
Produces under <out_root>:
    scans/sceneXXXX_00/frames/{color/*.jpg, pose/*.txt, intrinsic/intrinsic_color.txt}
    scans/sceneXXXX_00/sceneXXXX_00.txt        (axisAlignment meta)
    full_annotations.json                      (Scan2CAD GT)
    val.txt                                    (split file)
    rehearsal.yaml                             (tiny model config)
"""
import argparse
import json
import os
import sys

import numpy as np
from PIL import Image

from ...mapping.prior import CLASS_MAPPER
from .common import IMG, K, REPO, SCENES, scene_views

SCRATCH_DIRS = ("runs", "chiprun_out", "result")   # the repository's git-ignored outputs


def output_root(root: str) -> str:
    """``root`` as an absolute path; raises ValueError for a root inside the
    repository outside its git-ignored output directories."""
    path = os.path.realpath(root)
    rel = os.path.relpath(path, os.path.realpath(REPO))
    inside = rel != os.pardir and not rel.startswith(os.pardir + os.sep)
    if inside and rel.split(os.sep)[0] not in SCRATCH_DIRS:
        raise ValueError(f"refusing to write the split to {root}: inside the repository, "
                         f"write under {', '.join(d + '/' for d in SCRATCH_DIRS)} or outside it")
    return path


YAML = """\
# tiny rehearsal config (matches examples/cli_rehearsal/common.py make_detr/make_assoc)
backbone: "resnet50"
position_embedding: 'sine'
enc_layers: 2
dec_layers: 2
dim_feedforward: 256
hidden_dim: 64
dropout: 0.0
nheads: 4
num_queries: 12
num_classes: 8
pre_norm: False
aux_loss: True
dataset_file: "scan_net"
masks: False
dilation: False

descriptor_dim: 64
keypoint_encoder: [78, 64, 64]
GNN_layers: ['self', 'cross', 'self', 'cross']
self_GNN_layers: ['self']
sinkhorn_iterations: 30
match_threshold: 0.2

dataset:
  img_h: 128
  img_w: 128
"""


def yaw_quat(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def main(root: str) -> None:
    root = output_root(root)
    scans = os.path.join(root, "scans")
    annotations = []
    K44 = np.eye(4)
    K44[:3, :3] = K
    aa_line = "axisAlignment = " + " ".join(str(v) for v in np.eye(4).reshape(-1))

    for scene_id, objects in SCENES.items():
        base = os.path.join(scans, scene_id, "frames")
        for sub in ("color", "pose", "intrinsic"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        np.savetxt(os.path.join(base, "intrinsic", "intrinsic_color.txt"), K44)
        with open(os.path.join(scans, scene_id, f"{scene_id}.txt"), "w") as f:
            f.write(aa_line + "\n")
        for fid, T_wc, img, _ in scene_views(scene_id):
            Image.fromarray(img).save(
                os.path.join(base, "color", f"{fid}.jpg"), quality=95
            )
            np.savetxt(os.path.join(base, "pose", f"{fid}.txt"), T_wc)

        annotations.append({
            "id_scan": scene_id,
            "trs": {"translation": [0, 0, 0], "rotation": [1, 0, 0, 0],
                    "scale": [1, 1, 1]},
            "aligned_models": [
                {
                    "catid_cad": CLASS_MAPPER[cls],
                    "id_cad": f"synthetic_{i}",
                    "trs": {"translation": [float(v) for v in c],
                            "rotation": yaw_quat(yaw),
                            "scale": [1.0, 1.0, 1.0]},
                    "bbox": [float(v) for v in dims / 2],
                }
                for i, (c, dims, yaw, cls, _) in enumerate(objects)
            ],
        })

    with open(os.path.join(root, "full_annotations.json"), "w") as f:
        json.dump(annotations, f)
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(SCENES) + "\n")
    with open(os.path.join(root, "rehearsal.yaml"), "w") as f:
        f.write(YAML)
    n = sum(len(os.listdir(os.path.join(scans, s, "frames", "color"))) for s in SCENES)
    print(f"wrote {len(SCENES)} scenes, {n} frames, {IMG}x{IMG}, to {root}")


def main_hard(root: str, seeds=None, n_frames=None) -> None:
    """Write the HARD (discriminative) val split: procedural 8-10-object
    scenes with same-class duplicates, texture, occlusion, border
    truncation, and pose noise (see hard.py).  Same on-disk layout as
    :func:`main`; evaluation seeds only — training uses held-out seeds via
    the trainer's ODAM_HARD mode.  ``seeds`` overrides EVAL_SEEDS (used by
    --tune to emit the operating-point tuning split, hard.TUNE_SEEDS —
    thresholds are selected there, never on the eval scenes)."""
    from .hard import (EVAL_SEEDS, IMG as IMG_HARD, K as K_HARD,
                       hard_scene_annotation, hard_scene_id, hard_scene_views)

    root = output_root(root)
    if seeds is None:
        seeds = EVAL_SEEDS

    scans = os.path.join(root, "scans")
    annotations = []
    K44 = np.eye(4)
    K44[:3, :3] = K_HARD
    aa_line = "axisAlignment = " + " ".join(str(v) for v in np.eye(4).reshape(-1))

    scene_ids = []
    for seed in seeds:
        scene_id = hard_scene_id(seed)
        scene_ids.append(scene_id)
        base = os.path.join(scans, scene_id, "frames")
        for sub in ("color", "pose", "intrinsic"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        np.savetxt(os.path.join(base, "intrinsic", "intrinsic_color.txt"), K44)
        with open(os.path.join(scans, scene_id, f"{scene_id}.txt"), "w") as f:
            f.write(aa_line + "\n")
        view_kwargs = {} if n_frames is None else {"n_frames": n_frames}
        for fid, T_wc, img, _, _ in hard_scene_views(seed, **view_kwargs):
            Image.fromarray(img).save(
                os.path.join(base, "color", f"{fid}.jpg"), quality=95
            )
            np.savetxt(os.path.join(base, "pose", f"{fid}.txt"), T_wc)
        annotations.append(hard_scene_annotation(seed))

    with open(os.path.join(root, "full_annotations.json"), "w") as f:
        json.dump(annotations, f)
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(scene_ids) + "\n")
    with open(os.path.join(root, "rehearsal.yaml"), "w") as f:
        # more query slots + 192px frames for the crowded scenes; stage-3
        # backbone features (12x12 grid) — stage 4's whole-image receptive
        # field makes held-out-layout generalization impossible for the
        # tiny frozen-random-backbone model (measured: tp 243/249 on train
        # layouts vs ~35% tp + 60% class error on eval layouts)
        f.write(YAML.replace("num_queries: 12", "num_queries: 16")
                    .replace('backbone: "resnet50"', 'backbone: "tiny"')
                    .replace("dilation: False",
                             "dilation: False\nbackbone_stage: 3")
                    .replace("img_h: 128", f"img_h: {IMG_HARD}")
                    .replace("img_w: 128", f"img_w: {IMG_HARD}"))
    n = sum(len(os.listdir(os.path.join(scans, s, "frames", "color")))
            for s in scene_ids)
    print(f"wrote {len(scene_ids)} HARD scenes, {n} frames, "
          f"{IMG_HARD}x{IMG_HARD}, to {root}")


def main_cli(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.cli_rehearsal.make_dataset",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("out_root")
    form = ap.add_mutually_exclusive_group()
    form.add_argument("--hard", action="store_true", help="the hard split (EVAL_SEEDS)")
    form.add_argument("--tune", action="store_true",
                      help="the hard split's operating-point tuning scenes (TUNE_SEEDS)")
    form.add_argument("--long", action="store_true",
                      help="the hard split's layouts on one slow 480-frame orbit")
    args = ap.parse_args(argv)
    if args.tune:
        from .hard import TUNE_SEEDS

        main_hard(args.out_root, seeds=TUNE_SEEDS)
    elif args.long:
        # the associator-window experiment's long-stream split: tracks
        # accumulate ~15x more observations than the 32-frame split, so the
        # 100-row window (the reference's bound, src/processor.py:133-178)
        # truncates history
        main_hard(args.out_root, n_frames=480)
    elif args.hard:
        main_hard(args.out_root)
    else:
        main(args.out_root)


if __name__ == "__main__":
    main_cli(sys.argv[1:])
