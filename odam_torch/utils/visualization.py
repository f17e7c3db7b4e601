"""Visualization utilities: 2D boxes, BEV layouts, mesh export.

Counterpart of ``odam_tpu/utils/visualization.py`` (the reference's
src/utils/visual_utils.py, src/utils/o3d_helper.py and
src/viewers/result_viewer.py) without hard dependencies: matplotlib and
Open3D are imported lazily; superquadric surfaces are computed on the host
with :mod:`odam_torch.ops.surface` and export to Wavefront OBJ, so any viewer
opens them.
"""
from __future__ import annotations

import numpy as np


def draw_boxes_2d(ax, boxes_xyxy: np.ndarray, labels=None, color="lime"):
    """Draw xyxy boxes on a matplotlib axis (visual_utils.py:90-133)."""
    import matplotlib.patches as patches

    for i, b in enumerate(np.atleast_2d(boxes_xyxy)):
        ax.add_patch(
            patches.Rectangle(
                (b[0], b[1]), b[2] - b[0], b[3] - b[1],
                linewidth=1.5, edgecolor=color, facecolor="none",
            )
        )
        if labels is not None:
            ax.text(b[0], b[1] - 2, str(labels[i]), color=color, fontsize=8)


def draw_bev(ax, corner_sets: list[np.ndarray], colors=None):
    """Bird's-eye-view outlines of 8-corner boxes (top face)."""
    for i, corners in enumerate(corner_sets):
        poly = np.asarray(corners)[:4, :2]
        poly = np.concatenate([poly, poly[:1]], axis=0)
        c = None if colors is None else colors[i % len(colors)]
        ax.plot(poly[:, 0], poly[:, 1], color=c)
    ax.set_aspect("equal")


def save_detection_snapshot(path: str, image: np.ndarray, boxes: np.ndarray,
                            labels=None, scores=None):
    """Write an annotated detection image (visual_utils.py:220-337)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.imshow(image)
    text = None
    if labels is not None and scores is not None:
        text = [f"{l}:{s:.2f}" for l, s in zip(labels, scores)]
    draw_boxes_2d(ax, boxes, text)
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def save_matching_snapshot(path: str, image: np.ndarray,
                           track_boxes: np.ndarray, det_boxes: np.ndarray,
                           matches: np.ndarray):
    """Visualize association decisions on one frame.

    Track boxes draw cyan, detections green (matched, labeled with the track
    id) or red (unmatched) — the reference's matching visualization
    (visual_utils.py:134-175) without its side-by-side frame pair.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.imshow(image)
    draw_boxes_2d(ax, track_boxes, color="cyan")
    matched = np.asarray(matches) >= 0
    if matched.any():
        draw_boxes_2d(
            ax, np.atleast_2d(det_boxes)[matched],
            labels=[f"t{int(t)}" for t in np.asarray(matches)[matched]],
            color="lime",
        )
    if (~matched).any():
        draw_boxes_2d(ax, np.atleast_2d(det_boxes)[~matched], color="red")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def plot_loss(path: str, losses, label: str = "loss"):
    """Loss-curve plot (visual_utils.py:338 equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(np.asarray(losses))
    ax.set_xlabel("iteration")
    ax.set_ylabel(label)
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def sq_surface_mesh(params, grid: int = 48) -> tuple[np.ndarray, np.ndarray]:
    """Triangulated superquadric surface: -> (vertices [V, 3], faces [F, 3]).

    Structured (eta, omega) grid triangulation of one SQParams object (its
    fields numpy arrays or tensors, computed in float32 on the host); the
    reference's equivalent path is SQ surface -> convex hull -> trimesh
    (result_viewer.py:19-60).
    """
    import torch

    from ..mapping import superquadric as sq
    from ..ops import surface
    from . import geometry as geo

    p = sq.SQParams(*[torch.as_tensor(x).detach().cpu().float() for x in params])
    etas = np.linspace(-np.pi / 2 + 1e-3, np.pi / 2 - 1e-3, grid)
    omegas = np.linspace(-np.pi, np.pi, grid)
    ee, oo = np.meshgrid(etas, omegas, indexing="ij")
    with torch.no_grad():
        pts, _ = surface.sq_surface_points(
            sq.effective_scales(p), sq.effective_epsilons(p),
            torch.from_numpy(ee.ravel()).float(), torch.from_numpy(oo.ravel()).float(),
        )
        R = geo.rotz(p.angle)
    verts = pts.numpy() @ R.numpy().T + p.translate.numpy()

    faces = []
    for i in range(grid - 1):
        for j in range(grid - 1):
            a = i * grid + j
            b = a + 1
            c = a + grid
            d = c + 1
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, np.int64)


def export_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a Wavefront OBJ mesh (1-indexed faces)."""
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def export_scene_obj(path: str, quadrics: list, grid: int = 32) -> None:
    """Export all of a scene's optimized superquadrics as one OBJ."""
    all_v, all_f = [], []
    offset = 0
    for q in quadrics:
        v, f = sq_surface_mesh(q, grid)
        all_v.append(v)
        all_f.append(f + offset)
        offset += len(v)
    export_obj(path, np.concatenate(all_v), np.concatenate(all_f))


def view_scene_open3d(quadrics: list, scene_mesh_path: str | None = None):
    """Interactive Open3D viewer (result_viewer.py:19-60); requires open3d."""
    import open3d as o3d

    geoms = []
    for q in quadrics:
        v, f = sq_surface_mesh(q)
        mesh = o3d.geometry.TriangleMesh(
            o3d.utility.Vector3dVector(v), o3d.utility.Vector3iVector(f)
        )
        mesh.compute_vertex_normals()
        geoms.append(mesh)
    if scene_mesh_path:
        geoms.append(o3d.io.read_triangle_mesh(scene_mesh_path))
    o3d.visualization.draw_geometries(geoms)
