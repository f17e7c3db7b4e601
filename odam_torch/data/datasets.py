"""Training datasets: detector frames and associator track pairs.

Counterpart of ``odam_tpu/data/datasets.py``, the same numpy code: batch
iterators yielding padded, fixed-shape arrays for the train steps.

Detector annotations are per-frame JSON records
``{"img_path": ..., "objects": [[class, cx, cy, w, h, dx, dy, dz, off_x,
off_y, ..., depth, angle], ...]}`` with boxes/offsets in pixels (normalized
here) and angles in radians (binned to 30 classes).

Associator samples are built from track lists: for a scene at frame t, the
inputs are each track's history before t (the last ``window`` rows) and the
frame-t observations as detections, with the ground-truth matches given by
track identity.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from ..models.criterion import Targets

ANGLE_BINS = 30


def angle_to_class(angle_rad: np.ndarray, num_bins: int = ANGLE_BINS) -> np.ndarray:
    """Radians -> [0, num_bins) azimuth class (geometry_utils.py:114-132)."""
    deg = np.degrees(np.arctan2(np.sin(angle_rad), np.cos(angle_rad)))
    deg = np.where(deg < 0, deg + 180.0, deg)
    return np.clip(deg // (180.0 / num_bins), 0, num_bins - 1).astype(np.int32)


def pack_targets(object_rows: list[np.ndarray], max_objects: int) -> Targets:
    """Pad a batch of per-image object arrays into Targets of numpy arrays."""
    B = len(object_rows)
    M = max_objects
    t = Targets(
        classes=np.zeros((B, M), np.int32),
        boxes=np.zeros((B, M, 4), np.float32),
        sizes=np.zeros((B, M, 3), np.float32),
        offsets=np.zeros((B, M, 2), np.float32),
        depths=np.zeros((B, M), np.float32),
        angle_bins=np.zeros((B, M), np.int32),
        mask=np.zeros((B, M), bool),
    )
    for b, rows in enumerate(object_rows):
        rows = np.asarray(rows, np.float32)[:M]
        n = len(rows)
        if n == 0:
            continue
        t.classes[b, :n] = rows[:, 0].astype(np.int32)
        t.boxes[b, :n] = rows[:, 1:5]
        t.sizes[b, :n] = rows[:, 5:8]
        t.offsets[b, :n] = rows[:, 8:10]
        t.depths[b, :n] = rows[:, -2]
        t.angle_bins[b, :n] = angle_to_class(rows[:, -1])
        t.mask[b, :n] = True
    return t


@dataclass
class DetectorDataset:
    """Per-frame detection dataset from a JSON annotation file."""

    json_path: str
    max_objects: int = 30

    def __post_init__(self):
        with open(self.json_path) as f:
            data = json.load(f)
        self.records = [d for d in data if len(d["objects"]) > 0]

    def __len__(self) -> int:
        return len(self.records)

    def load(self, idx: int, out_h: int, out_w: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (normalized image [H, W, 3], objects with normalized box/offset)."""
        from PIL import Image

        from . import transforms

        rec = self.records[idx]
        img = np.asarray(Image.open(rec["img_path"]))
        h, w = img.shape[:2]
        image = transforms.preprocess_image(img, out_h, out_w)
        objects = np.asarray(rec["objects"], np.float32).copy()
        objects[:, 1:5] /= np.array([w, h, w, h], np.float32)
        objects[:, 8:10] = np.clip(
            objects[:, 8:10] / np.array([w, h], np.float32), -1.0, 2.0
        )
        return image, objects

    def batches(self, batch_size: int, out_h: int, out_w: int,
                rng: np.random.Generator, epochs: int | None = None):
        """Yield (images [B, H, W, 3], Targets)."""
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.records))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                imgs, objs = [], []
                for idx in order[start : start + batch_size]:
                    im, ob = self.load(int(idx), out_h, out_w)
                    imgs.append(im)
                    objs.append(ob)
                yield np.stack(imgs), pack_targets(objs, self.max_objects)
            epoch += 1


def rows82_to_model79(rows: np.ndarray, T_wc: np.ndarray | None,
                      img_w: float | None, img_h: float | None) -> np.ndarray:
    """World-frame 82-dim track rows -> 79-dim model input rows.

    With a camera pose, performs the reference's world->camera re-encoding
    (processor.py:133-179): bbox columns normalized by image size, t_wo ->
    t_co, azimuth relative to the camera azimuth as sin/cos.  Without a pose
    (synthetic data), columns are copied through.
    """
    out = np.full((len(rows), 79), -1.0, np.float32)
    out[:, 0] = rows[:, 0]
    out[:, 1] = rows[:, 1]
    if T_wc is not None:
        from . import scannet as scannet_mod

        T_cw = np.linalg.inv(T_wc)
        cam_azi = scannet_mod.get_cam_azi(T_wc)
        norm = np.array([img_w, img_h, img_w, img_h], np.float32)
        out[:, 2:6] = np.clip(rows[:, 2:6] / norm, -1.0, 2.0)
        t_wo = np.concatenate([rows[:, 9:12], np.ones((len(rows), 1))], axis=1)
        out[:, 9:12] = (t_wo @ T_cw.T)[:, :3]
        ang = rows[:, 12] - cam_azi
        out[:, 12] = np.sin(ang)
        out[:, 13] = np.cos(ang)
    else:
        out[:, 2:6] = rows[:, 2:6]
        out[:, 9:12] = rows[:, 9:12]
        out[:, 12] = np.sin(rows[:, 12])
        out[:, 13] = np.cos(rows[:, 12])
    out[:, 6:9] = rows[:, 6:9]
    out[:, 14] = rows[:, 13]
    if rows.shape[1] >= 78:
        out[:, 15:79] = rows[:, 14:78]
    return out


def build_association_sample(tracks: list[np.ndarray], frame_id: float,
                             max_tracks: int, max_dets: int, window: int,
                             T_wc: np.ndarray | None = None,
                             img_w: float | None = None,
                             img_h: float | None = None,
                             extra_dets: np.ndarray | None = None) -> dict | None:
    """One associator training sample at a given frame.

    Returns dict with tracks [T, W, 79], track_mask [T], dets [N, 79],
    det_mask [N], gt_pairs [P, 2] (incl. dustbin targets for unmatched
    slots), pair_valid [P] — or None if the frame yields no detections or no
    history.

    ``extra_dets``: optional [K, 82] distractor rows appended as detections
    with dustbin targets — false-positive augmentation.  Real detectors
    hallucinate transient boxes (the hard rehearsal measured 238 fp over 48
    frames); an associator trained only on GT-derived detections has never
    seen one and learns to attach every geometrically plausible box.
    """
    hist, dets, gt = [], [], []
    for t_idx, track in enumerate(tracks):
        past = track[track[:, 0] < frame_id][-window:]
        now = track[track[:, 0] == frame_id]
        if len(past) > 0:
            hist.append((t_idx, past))
        if len(now) > 0:
            dets.append((t_idx, now[0]))
    if not hist or not dets:
        return None
    hist = hist[:max_tracks]
    if extra_dets is not None:
        dets.extend((-1, row) for row in np.asarray(extra_dets))
    dets = dets[:max_dets]
    slot_of = {t_idx: s for s, (t_idx, _) in enumerate(hist)}

    T, N, W = max_tracks, max_dets, window
    tr = np.full((T, W, 79), -1.0, np.float32)
    tm = np.zeros((T,), bool)
    de = np.full((N, 79), -1.0, np.float32)
    dm = np.zeros((N,), bool)

    for s, (_, past) in enumerate(hist):
        k = len(past)
        tr[s, :k] = rows82_to_model79(past, T_wc, img_w, img_h)
        tm[s] = True
    for d, (_, row) in enumerate(dets):
        de[d] = rows82_to_model79(row[None], T_wc, img_w, img_h)[0]
        dm[d] = True

    # GT pairs: matched (slot, det); unmatched det -> dustbin row T;
    # unmatched track -> dustbin col N (the reference's gt score matrix
    # includes dustbins, scan_net_track.py:33-97).
    pairs = []
    matched_slots = set()
    for d, (t_idx, _) in enumerate(dets):
        if t_idx in slot_of:
            pairs.append((slot_of[t_idx], d))
            matched_slots.add(slot_of[t_idx])
        else:
            pairs.append((T, d))
    for s in range(len(hist)):
        if s not in matched_slots:
            pairs.append((s, N))
    gt_pairs = np.asarray(pairs, np.int32)
    return {
        "tracks": tr, "track_mask": tm, "detections": de, "det_mask": dm,
        "gt_pairs": gt_pairs, "pair_valid": np.ones(len(pairs), bool),
    }


@dataclass
class AssociatorDataset:
    """Associator training samples from per-scene track lists."""

    scenes: dict  # {scene_id: list of [n_obs, >=78] track arrays}
    max_tracks: int = 64
    max_dets: int = 30
    window: int = 100
    max_pairs: int = 96

    def __post_init__(self):
        self.samples = []
        for scene, tracks in self.scenes.items():
            frames = np.unique(np.concatenate([t[:, 0] for t in tracks]))
            for f in frames[1:]:
                self.samples.append((scene, float(f)))

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, idx: int) -> dict | None:
        scene, frame = self.samples[idx]
        out = build_association_sample(
            self.scenes[scene], frame, self.max_tracks, self.max_dets, self.window
        )
        if out is None:
            return None
        P = self.max_pairs
        pairs = np.zeros((P, 2), np.int32)
        valid = np.zeros((P,), bool)
        k = min(len(out["gt_pairs"]), P)
        pairs[:k] = out["gt_pairs"][:k]
        valid[:k] = True
        out["gt_pairs"] = pairs
        out["pair_valid"] = valid
        return out

    def batches(self, batch_size: int, rng: np.random.Generator,
                epochs: int | None = None):
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.samples))
            batch = []
            for idx in order:
                s = self.get(int(idx))
                if s is not None:
                    batch.append(s)
                if len(batch) == batch_size:
                    yield {
                        k: np.stack([b[k] for b in batch]) for k in batch[0]
                    }
                    batch = []
            epoch += 1
