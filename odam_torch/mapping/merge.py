"""Track merging: fuse fragmented tracks of the same physical object (a copy
of ``odam_tpu/mapping/merge.py``).

Capability parity with the reference merge stage (run_merge.py:25-130):
pairwise cost = 1 - oriented-3D-IoU of the optimized boxes for mergeable class
pairs (same class, or the sofa/chair pair {4, 5}), average-linkage
agglomerative clustering with distance threshold 0.95, then per-cluster track
fusion that keeps, for every frame, the detection from the longest member
track and rewrites classes to the cluster's dominant class.

Host-side NumPy (object counts are tiny).
"""
from __future__ import annotations

import numpy as np

from ..utils import host_boxes, metrics

MERGEABLE_GROUPS = [{4, 5}]  # sofa / chair (run_merge.py:107-108)
MERGE_DISTANCE_THRESHOLD = 0.95


def average_linkage_clusters(dist: np.ndarray, threshold: float) -> np.ndarray:
    """Average-linkage agglomerative clustering on a precomputed distance matrix.

    Merges the closest cluster pair until the minimum average inter-cluster
    distance exceeds ``threshold`` (same contract as sklearn's
    AgglomerativeClustering(affinity="precomputed", linkage="average",
    distance_threshold=threshold) used at run_merge.py:81-85).

    Returns:
        labels [N] int cluster ids (0..k-1).
    """
    n = len(dist)
    clusters: list[list[int]] = [[i] for i in range(n)]
    dist = np.asarray(dist, np.float64)

    def avg_dist(a: list[int], b: list[int]) -> float:
        return float(dist[np.ix_(a, b)].mean())

    while len(clusters) > 1:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = avg_dist(clusters[i], clusters[j])
                if best is None or d < best[0]:
                    best = (d, i, j)
        if best is None or best[0] > threshold:
            break
        _, i, j = best
        clusters[i] = clusters[i] + clusters[j]
        del clusters[j]

    labels = np.zeros(n, np.int64)
    for cid, members in enumerate(clusters):
        for m in members:
            labels[m] = cid
    return labels


def is_mergeable(class_a: int, class_b: int) -> bool:
    if class_a == class_b:
        return True
    return any(class_a in g and class_b in g for g in MERGEABLE_GROUPS)


def merge_cost_matrix(tracks: list[np.ndarray], corners: list[np.ndarray]) -> np.ndarray:
    """Pairwise merge cost: 1 - oriented-3D-IoU for mergeable pairs, else 1."""
    n = len(tracks)
    cost = np.zeros((n, n))
    classes = [int(np.median(t[:, 1])) for t in tracks]
    for i in range(n):
        for j in range(i + 1, n):
            if is_mergeable(classes[i], classes[j]):
                iou, _ = host_boxes.box3d_iou(
                    np.asarray(corners[i], np.float64), np.asarray(corners[j], np.float64)
                )
                cost[i, j] = 1.0 - iou
            else:
                cost[i, j] = 1.0
    return cost + cost.T


def fuse_cluster(tracks: list[np.ndarray], member_mask: np.ndarray,
                 frame_ids: np.ndarray) -> np.ndarray:
    """Fuse one cluster of tracks into a single track.

    Per frame, keep the observation from the longest member track; rewrite
    the class column to the cluster's modal class (run_merge.py:25-57).
    """
    members = [t for t, m in zip(tracks, member_mask) if m]
    all_classes = np.concatenate([t[:, 1] for t in members])
    vals, counts = np.unique(all_classes, return_counts=True)
    dominant = vals[np.argmax(counts)]

    lengths = [len(t) for t in members]
    rows = []
    for fid in frame_ids:
        candidates = [
            (lengths[k], t[t[:, 0] == fid][0])
            for k, t in enumerate(members)
            if (t[:, 0] == fid).any()
        ]
        if not candidates:
            continue
        row = max(candidates, key=lambda c: c[0])[1].copy()
        row[1] = dominant
        rows.append(row)
    return np.asarray(rows) if rows else np.zeros((0, tracks[0].shape[1]))


def merge_tracks(tracks: list[np.ndarray], corners: list[np.ndarray],
                 frame_ids: np.ndarray,
                 threshold: float = MERGE_DISTANCE_THRESHOLD) -> list[np.ndarray]:
    """Full merge stage: cluster by box overlap, fuse clusters.

    Args:
        tracks: list of [n_obs, 82] arrays.
        corners: list of [8, 3] optimized oriented boxes (bboxes_qc).
        frame_ids: [F] usable frame ids of the scene.
    """
    if len(tracks) <= 1:
        return [t for t in tracks if len(t) > 0]
    with metrics.span("odam.merge.cost"):
        cost = merge_cost_matrix(tracks, corners)
    with metrics.span("odam.merge.linkage"):
        labels = average_linkage_clusters(cost, threshold)
    merged = []
    for cid in np.unique(labels):
        fused = fuse_cluster(tracks, labels == cid, frame_ids)
        if len(fused) > 0:
            merged.append(fused)
    return merged
