"""Shared synthetic scene and model definitions of the segmented closed loop.

Counterpart of ``examples/closed_loop/closed_scene.py``: the same scene,
renderer and views; the box corners and the camera azimuth go through the
port's float32 geometry (:mod:`odam_torch.utils.geometry`) as JAX's go
through its own.
"""
import numpy as np
import torch

from ...data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ...utils import geometry as geo

IMG = 128
K = np.array([[100., 0, 64], [0, 100., 64], [0, 0, 1]], np.float32)
OBJECTS = [
    (np.array([0.0, 0.0, 0.4]), np.array([0.6, 0.6, 0.8]), 0.4, 5, (255, 60, 60)),
    (np.array([1.5, 0.4, 0.3]), np.array([1.0, 0.6, 0.6]), 2.0, 1, (60, 255, 60)),
    (np.array([-0.4, 1.3, 0.25]), np.array([0.45, 0.4, 0.5]), 1.2, 3, (80, 80, 255)),
]


def look_at(cam, target):
    fwd = target - cam
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 0, 1.])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, cam
    return T


def box_corners(dims, yaw, center) -> np.ndarray:
    """``geometry.box3d_corners`` in float32, as a numpy [8, 3] array."""
    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32)

    return geo.box3d_corners(f32(dims), f32(yaw), f32(center)).numpy()


def render(T_wc):
    img = np.full((IMG, IMG, 3), 30, np.uint8)
    T_cw = np.linalg.inv(T_wc)
    objs, order = [], []
    for (c, dims, yaw, cls, color) in OBJECTS:
        corners = box_corners(dims, yaw, c)
        pc = corners @ T_cw[:3, :3].T + T_cw[:3, 3]
        if pc[:, 2].min() < 0.3:
            continue
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        x0, y0 = uv.min(0)
        x1, y1 = uv.max(0)
        if x1 < 5 or y1 < 5 or x0 > IMG - 5 or y0 > IMG - 5:
            continue
        order.append((pc[:, 2].mean(), (x0, y0, x1, y1), c, dims, yaw, cls, color))
    for depth, (x0, y0, x1, y1), c, dims, yaw, cls, color in sorted(order, key=lambda o: -o[0]):
        img[max(int(y0), 0):min(int(y1), IMG), max(int(x0), 0):min(int(x1), IMG)] = color
        T_cw2 = np.linalg.inv(T_wc)
        t_co = T_cw2[:3, :3] @ c + T_cw2[:3, 3]
        proj = K @ t_co
        sc = proj[:2] / proj[2]
        cam_azi = float(geo.camera_azimuth(torch.from_numpy(T_wc.astype(np.float32))))
        row = [cls, (x0 + x1) / 2 / IMG, (y0 + y1) / 2 / IMG, (x1 - x0) / IMG, (y1 - y0) / IMG,
               dims[0], dims[1], dims[2],
               (sc[0] - (x0 + x1) / 2) / IMG, (sc[1] - (y0 + y1) / 2) / IMG, t_co[2],
               yaw - cam_azi]
        objs.append(row)
    return img, np.asarray(objs, np.float32)


def ring_pose(phi: float) -> np.ndarray:
    """The camera on the loop's ring at azimuth ``phi``, looking at the scene."""
    cam = np.array([0.4 + 3.2 * np.cos(phi), 0.5 + 3.2 * np.sin(phi), 1.6])
    return look_at(cam, np.array([0.4, 0.5, 0.4])).astype(np.float32)


def make_train_views():
    views = []
    for k in range(24):
        T_wc = ring_pose(2 * np.pi * k / 24)
        img, objs = render(T_wc)
        if len(objs):
            views.append((img, objs, T_wc))
    return views


def make_detr(use_kernels: bool = True):
    """The loop's DETR config (JAX's ``make_detr`` returns ``model, cfg``):
    build it with ``detr.build_detr``.  Training turns ``use_kernels`` off."""
    from ...models import detr as detr_mod

    return detr_mod.DETRConfig(num_classes=8, num_queries=12, hidden_dim=64, nheads=4,
                               enc_layers=2, dec_layers=2, dim_feedforward=256,
                               aux_loss=True, dropout=0.0, dtype=torch.float32,
                               use_kernels=use_kernels)


def norm(img):
    return ((img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
