"""Scan2CAD evaluation protocol: per-class F1 at oriented-3D-IoU 0.25.

Counterpart of ``odam_tpu/eval/scan2cad.py``: parse Scan2CAD
full_annotations.json into world-frame GT boxes, load per-scene prediction
pickles, greedily match same-class predictions to GT by oriented 3D IoU,
and report per-class and average precision/recall/F1.  Either package's
pickles load here: a pickled ``SQParams`` of the JAX package is read as the
port's, so loading one imports no JAX.
"""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field

import numpy as np

import torch

from ..data import scannet
from ..mapping import superquadric
from ..mapping.prior import CLASS_MAPPER, CLASS_NAMES
from ..utils import geometry as geo
from ..utils import host_boxes

CARE_CLASSES = CLASS_NAMES


def corners_by_dims(dims: np.ndarray) -> np.ndarray:
    """8 corners of an origin-centered box (eval_scan2cad.py:93-106 order), in
    float32 as the JAX package computes them (x64 off)."""
    return geo.corners_from_dims(torch.from_numpy(np.asarray(dims, np.float32))).numpy()


class _ResultUnpickler(pickle.Unpickler):
    """Reads a result pickle of either package: the JAX package's SQParams
    maps to the port's (same fields), so no JAX module is imported."""

    def find_class(self, module, name):
        if (module, name) == ("odam_tpu.mapping.superquadric", "SQParams"):
            return superquadric.SQParams
        return super().find_class(module, name)


def parse_scan2cad_annotations(scan: dict, T_align: np.ndarray | None = None) -> list:
    """One scan's annotations -> [(catid, corners [8, 3])] in aligned world frame.

    Reference behavior: eval_scan2cad.py:218-246 — scene pose inverted,
    per-model scale folded into the CAD bbox half-extents, degenerate scales
    skipped.
    """
    T_ws = scannet.make_M_from_tqs(
        scan["trs"]["translation"], scan["trs"]["rotation"], scan["trs"]["scale"]
    )
    T_sw = np.linalg.inv(T_ws)
    out = []
    for model in scan["aligned_models"]:
        cat = model["catid_cad"]
        if cat not in CARE_CLASSES:
            continue
        s = np.asarray(model["trs"]["scale"])
        if s.min() < 1e-3:
            continue
        dims = np.asarray(model["bbox"]) * s * 2
        T_wo = T_sw @ scannet.make_M_from_tqs(
            model["trs"]["translation"], model["trs"]["rotation"], np.ones(3)
        )
        corners = corners_by_dims(dims)
        corners = corners @ T_wo[:3, :3].T + T_wo[:3, 3]
        if T_align is not None:
            corners = corners @ T_align[:3, :3].T + T_align[:3, 3]
        out.append((cat, corners))
    return out


def load_predictions(result_dir: str, min_views: int = 1) -> dict[str, list]:
    """Per-scene predictions from run_processor pickles
    (eval_scan2cad.py:191-215; missing scenes tolerated)."""
    predictions: dict[str, list] = {}
    for scene in sorted(os.listdir(result_dir)):
        if not scene.startswith("scene"):
            continue
        path = os.path.join(result_dir, scene, scene)
        predictions[scene] = []
        if not os.path.exists(path):
            print(f"{path} does not exist")
            continue
        with open(path, "rb") as f:
            data = _ResultUnpickler(f).load()
        for obj_id, track in enumerate(data["tracks"]):
            if len(track) < min_views:
                continue
            cls = int(np.median(track[:, 1]))
            if CLASS_MAPPER.get(cls) not in CARE_CLASSES:
                continue
            predictions[scene].append(
                {"bbox": np.asarray(data["bboxes_qc"][obj_id]),
                 "class": CLASS_MAPPER[cls]}
            )
    return predictions


def load_predictions_vid2cad(csv_path: str, axis_align_matrices: dict,
                             box2cad: dict, view_threshold: int = 1
                             ) -> dict[str, list]:
    """Vid2CAD CSV predictions -> the same per-scene prediction schema as
    :func:`load_predictions`, for the paper's headline comparison.

    Reference behavior (eval_scan2cad.py:148-188): one CSV row per aligned
    CAD model — ``scene_suffix, catid_cad, id_cad, t(3), q_wxyz(4), s(3),
    _, n_frames, score`` (header row skipped); classes outside the 8 cared
    categories dropped; per-model CAD-normalization scale folded in via the
    ``box2cad`` table (``s_box = s_csv / 2 * diag(box2cad[catid_id])[:3]``);
    corners at +-s_box/2 are lifted by T_wo = (t, q) and the scene's
    axis-align matrix; rows observed in fewer than ``view_threshold`` frames
    skipped.

    Args:
        csv_path: Vid2CAD results CSV.
        axis_align_matrices: scene id -> 4x4 axis-align matrix.
        box2cad: "catid_cadid" -> 4x4 CAD bbox-normalization matrix
            (the reference loads it from box2cad.json, eval_scan2cad.py:331).
    """
    import csv

    predictions: dict[str, list] = {}
    with open(csv_path) as f:
        rows = list(csv.reader(f, delimiter=","))
    for row in rows[1:]:  # first line is the header (eval_scan2cad.py:152)
        scan_id = f"scene{row[0]}"
        if scan_id not in axis_align_matrices:
            # The reference always passes the full val split; this API accepts
            # subsets, so rows for out-of-split scenes are skipped, not fatal.
            continue
        predictions.setdefault(scan_id, [])
        catid_cad = row[1]
        if catid_cad not in CARE_CLASSES:
            continue
        cadkey = f"{catid_cad}_{row[2]}"
        b2c = np.asarray(box2cad[cadkey], dtype=np.float64)

        t = np.asarray(row[3:6], dtype=np.float64)
        q = np.asarray(row[6:10], dtype=np.float64)  # wxyz
        s = np.asarray(row[10:13], dtype=np.float64) / 2
        s = s * np.diagonal(b2c)[:3]

        T_wo = scannet.make_M_from_tqs(t, q, np.ones(3))
        corners = corners_by_dims(s)
        corners = corners @ T_wo[:3, :3].T + T_wo[:3, 3]
        T_align = np.asarray(axis_align_matrices[scan_id], dtype=np.float64)
        corners = corners @ T_align[:3, :3].T + T_align[:3, 3]

        if int(row[14]) < view_threshold:
            continue
        predictions[scan_id].append(
            {"class": catid_cad, "bbox": corners,
             "num_frames": row[14], "scores": row[15]}
        )
    return predictions


@dataclass
class F1Counts:
    gts: dict = field(default_factory=lambda: {k: 0 for k in CARE_CLASSES})
    preds: dict = field(default_factory=lambda: {k: 0 for k in CARE_CLASSES})
    tps: dict = field(default_factory=lambda: {k: 0 for k in CARE_CLASSES})


def match_sequence(counts: F1Counts, predictions: list, gts: list,
                   threshold: float = 0.25) -> None:
    """Greedy class-matched TP counting (eval_scan2cad.py:249-267)."""
    used = set()
    for cat, _ in gts:
        counts.gts[cat] += 1
    for pred in predictions:
        counts.preds[pred["class"]] += 1
        for i, (cat, gt_box) in enumerate(gts):
            if cat != pred["class"]:
                continue
            iou, _ = host_boxes.box3d_iou(
                np.asarray(gt_box, np.float64), np.asarray(pred["bbox"], np.float64)
            )
            if iou > threshold and i not in used:
                used.add(i)
                counts.tps[pred["class"]] += 1


def summarize(counts: F1Counts, verbose: bool = True) -> dict:
    """Per-class + average precision/recall/F1 (eval_scan2cad.py:270-294)."""
    out = {}
    tot_g = tot_p = tot_t = 0
    for c in CARE_CLASSES:
        g, p, t = counts.gts[c], counts.preds[c], counts.tps[c]
        prec = t / p if p else 0.0
        rec = t / g if g else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        out[CARE_CLASSES[c]] = {"precision": prec, "recall": rec, "f1": f1}
        if verbose:
            print(f"class {CARE_CLASSES[c]}: precision {prec:.4f} recall {rec:.4f} F1 {f1:.4f}")
        tot_g += g
        tot_p += p
        tot_t += t
    prec = tot_t / tot_p if tot_p else 0.0
    rec = tot_t / tot_g if tot_g else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    out["average"] = {"precision": prec, "recall": rec, "f1": f1}
    if verbose:
        print(f"average: precision {prec:.4f} recall {rec:.4f} F1 {f1:.4f}")
    return out


def evaluate(result_dir: str, scan2cad_path: str, scans_root: str,
             sequences: list[str], threshold: float = 0.25,
             min_views: int = 1, verbose: bool = True,
             vid2cad_csv: str | None = None,
             box2cad_path: str | None = None) -> dict:
    """Full protocol over a validation split (eval_scan2cad.py:307-354).

    With ``vid2cad_csv`` (+ ``box2cad_path``), scores Vid2CAD CSV predictions
    through the same matching path instead of our pickles — the reference's
    comparison mode (eval_scan2cad.py:326-337).
    """
    with open(scan2cad_path) as f:
        scan2cad = json.load(f)
    seq_set = set(sequences)
    axis_aligns = {}
    for scene in sorted(seq_set):
        meta = os.path.join(scans_root, scene, f"{scene}.txt")
        if os.path.exists(meta):
            axis_aligns[scene] = scannet.read_axis_align(meta)
        else:
            # Tolerate partial scans_root (e.g. eval over a subset of the
            # split): scenes without meta can't be scored, but shouldn't
            # crash the scenes that can be.
            print(f"warning: missing axis-align meta for {scene}; skipping")
            seq_set.discard(scene)
    if vid2cad_csv is not None:
        with open(box2cad_path) as f:
            box2cad = json.load(f)
        predictions = load_predictions_vid2cad(
            vid2cad_csv, axis_aligns, box2cad, view_threshold=min_views
        )
    else:
        predictions = load_predictions(result_dir, min_views)
    counts = F1Counts()
    for scan in scan2cad:
        scene = scan["id_scan"]
        if scene not in predictions or scene not in seq_set:
            continue
        gts = parse_scan2cad_annotations(scan, axis_aligns[scene])
        match_sequence(counts, predictions[scene], gts, threshold)
    return summarize(counts, verbose)
