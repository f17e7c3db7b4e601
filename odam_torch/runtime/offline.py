"""Offline mode: detection batched ahead, association streamed over it.

Counterpart of ``odam_tpu/runtime/offline.py``.  Detection does not depend
on the track state, so for offline scene processing DETR runs over stacks
of ``batch_size`` frames (the last stack padded by repeating its last
frame) and only the tracking streams frame by frame over the cached
detections, through the online step's own :func:`processor.track_step`.

At a batch above ``ops.attention.KERNEL_MAX_BATCH`` (2) the detector's
attention takes the plain path, as in JAX; the associator's batch-1 GNN
calls still launch the fused kernel.  The JAX package can shard the
detector's batch over a device mesh; that waits for the mesh module
(ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .. import resolve_device
from ..data.loader import to_device
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..models import detr as detr_mod
from . import processor as proc_mod


class BatchedDetector:
    """DETR forward and postprocess over fixed-size stacks of frames."""

    def __init__(self, detr: detr_mod.DETR, cfg: proc_mod.PipelineConfig,
                 batch_size: int = 8, mesh=None, device: str | torch.device | None = None):
        if mesh is not None:
            raise NotImplementedError("a device mesh for the batched detector is not ported yet "
                                      "(ROADMAP Queue 1 item 11: parallel/mesh.py)")
        self.device = resolve_device(device)
        self.detr = detr.to(self.device).eval()
        self.cfg = cfg
        self.batch_size = batch_size
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    def detect_frames(self, frames: Iterable[np.ndarray], K: np.ndarray, img_w: float,
                      img_h: float) -> list[detr_mod.Detections]:
        """Detections of every frame, one batch-1 ``Detections`` each (views
        into the batch's tensors, on the device).  Frames are uint8 RGB or
        normalized float32 [H, W, 3]; with ``resize_on_device`` they are
        resized to (img_h, img_w) first."""
        frames = list(frames)
        B = self.batch_size
        K_dev = torch.from_numpy(np.ascontiguousarray(np.asarray(K, np.float32)[:3, :3])
                                 ).to(self.device)
        size = (int(img_h), int(img_w)) if self.cfg.resize_on_device else None
        out: list[detr_mod.Detections] = []
        for start in range(0, len(frames), B):
            chunk = frames[start:start + B]
            stack = np.stack(chunk + [chunk[-1]] * (B - len(chunk)))
            with torch.no_grad():
                images = proc_mod.device_images(stack, self.device, self._mean, self._std,
                                                self.detr.config.dtype, size)
                dets = proc_mod.detect_frame(self.cfg, self.detr, images, K_dev,
                                             float(img_w), float(img_h))
            out.extend(detr_mod.Detections(*[x[i:i + 1] for x in dets])
                       for i in range(len(chunk)))
        return out


class CachedDetectionPipeline(proc_mod.OdamPipeline):
    """The online pipeline fed with precomputed detections instead of images."""

    def __init__(self, associator, config: proc_mod.PipelineConfig = proc_mod.PipelineConfig(),
                 device: str | torch.device | None = None):
        super().__init__(None, associator, config, device)

    def process_detections(self, dets: detr_mod.Detections, frame_id: int,
                           T_wc: np.ndarray) -> proc_mod.FrameResult:
        """Track one frame's cached detections (a batch-1 ``Detections``)."""
        T_wc = self._record_frame(frame_id, T_wc)
        seq = self.sequence
        with torch.no_grad():
            result = proc_mod.track_step(
                self.cfg, self.associator, seq["store"], seq["log"], dets, float(frame_id),
                to_device(T_wc, self.device), seq["K_dev"], seq["img_w"],
                seq["img_h"], self._has_tracks)
        return self._finish_frame(result)

    def process_frame(self, *args, **kwargs):
        raise NotImplementedError("CachedDetectionPipeline takes Detections: "
                                  "use process_detections")


def run_scene_offline(detector: BatchedDetector, assoc_pipeline: CachedDetectionPipeline,
                      frames: list[np.ndarray], frame_ids: list[int], T_wcs: list[np.ndarray],
                      K: np.ndarray, img_h: float, img_w: float) -> dict:
    """A whole offline scene: batched detection, streamed tracking, then
    optim_process -> merge_process -> optim_process."""
    assoc_pipeline.init_sequence(K, img_h, img_w)
    detections = detector.detect_frames(frames, K, img_w, img_h)
    for dets, fid, T_wc in zip(detections, frame_ids, T_wcs):
        assoc_pipeline.process_detections(dets, fid, T_wc)
    out = assoc_pipeline.optim_process(assoc_pipeline.tracks)
    return assoc_pipeline.optim_process(assoc_pipeline.merge_process(out))
