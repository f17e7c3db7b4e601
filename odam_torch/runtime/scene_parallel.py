"""Scene-parallel lanes: P scenes advance together through one lane-batched step.

Counterpart of ``odam_tpu/runtime/scene_parallel.py`` on one device.  The
online step is sequential within a scene (association needs the previous
frame's tracks) but scenes are independent, so P of them run as lanes: each
step takes frame f of every lane's scene, and the models, the rows, the
associator and the track stores work on all P at once
(:func:`odam_torch.runtime.processor.lane_step_body`).  The stores and logs
carry a leading lane axis.  The step issues about as many launches for P
lanes as for one, so on a card that waits for the host this is where the
lanes pay.

As in JAX, scenes of different lengths are padded to the longest with
masked no-op frames (a zero image, frame id 0, an identity pose), the lane
axis is padded by repeating scene 0 with every frame masked, and each real
lane is finalized on the host after the frames: drain, ``optim_process``,
``merge_process``, ``optim_process``.  JAX's departures are kept: the log is
never drained in mid-scene, so a lane longer than ``max_log_frames`` loses
its later frames into ``n_lost`` (the serial pipeline drains instead).  The
JAX runner shards the lanes over a device mesh; that is ROADMAP Queue 1
item 11.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..data.loader import to_device
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from . import processor as proc_mod
from . import tracker


class SceneParallelRunner:
    """Drives ``n_lanes`` scenes at once through the lane-batched step.
    Runs on the card unless ``device="cpu"``."""

    def __init__(self, detr, associator, cfg: proc_mod.PipelineConfig, n_lanes: int,
                 device: str | torch.device | None = None):
        if int(n_lanes) < 1:
            raise ValueError(f"n_lanes must be at least 1, got {n_lanes}")
        self.device = resolve_device(device)
        self.detr = detr.to(self.device).eval()
        self.associator = associator.to(self.device).eval()
        self.cfg = cfg
        self.n_lanes = int(n_lanes)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    @property
    def host_syncs_total(self) -> int:
        """Blocking device-to-host waits of the steps so far: the exact
        decode's one packed copy a step, whatever the number of lanes."""
        return self.associator.host_syncs

    def step(self, stores: tracker.TrackStore, logs: tracker.FrameLog, images,
             meta: np.ndarray, Ks: torch.Tensor, img_h: float, img_w: float
             ) -> proc_mod.FrameResult:
        """One lane-batched step.  ``images``: [P, H, W, 3] uint8 (normalized
        on the device) or normalized float32; ``meta`` [P, 18] float32 rows
        of (frame id, T_wc row-major, valid), copied to the device at once."""
        dev = self.device
        P = self.n_lanes
        meta = to_device(np.ascontiguousarray(meta, np.float32), dev)
        with torch.no_grad():
            imgs = proc_mod.device_images(images, dev, self._mean, self._std,
                                          self.detr.config.dtype)
            return proc_mod.lane_step_body(
                self.cfg, self.detr, self.associator, stores, logs, imgs, meta[:, 0],
                meta[:, 1:17].reshape(P, 4, 4), Ks, float(img_w), float(img_h),
                meta[:, 17] > 0.5)

    def run_scenes(self, scenes: list[dict], img_h: float, img_w: float) -> list[dict]:
        """Run a group of scenes (at most ``n_lanes``) to completion.

        Args:
            scenes: dicts with ``frames`` (a sequence of [H, W, 3] uint8 or
                normalized float32 arrays, read once each in frame order),
                ``frame_ids``, ``T_wcs`` and ``K`` ([3, 3]).

        Returns one dict per scene, in order, as the serial chain gives it
        ({tracks, bboxes_qc, bboxes_dl, quadrics, loss_log}) after
        optim -> merge -> optim, with the lane's ``overflow_report``.
        """
        stores, logs = self.run_frames(scenes, img_h, img_w)
        return self.finalize(scenes, stores, logs, img_h, img_w)

    def run_frames(self, scenes: list[dict], img_h: float, img_w: float
                   ) -> tuple[tracker.TrackStore, tracker.FrameLog]:
        """Every frame of the group through the lane step: the lane-stacked
        stores and logs at the scenes' end (lanes past ``len(scenes)`` are
        padding)."""
        cfg, dev, P = self.cfg, self.device, self.n_lanes
        n_real = len(scenes)
        if not 1 <= n_real <= P:
            raise ValueError(f"{n_real} scenes for {P} lanes")
        lanes = scenes + [scenes[0]] * (P - n_real)
        n_frames = max(len(s["frames"]) for s in scenes)
        stores = tracker.init_store_lanes(P, cfg.max_tracks, cfg.window, dev)
        logs = tracker.init_log_lanes(P, cfg.max_log_frames, cfg.max_dets, dev)
        Ks = to_device(np.stack([np.asarray(s["K"], np.float32)[:3, :3] for s in lanes]), dev)

        zero_img = np.zeros_like(np.asarray(scenes[0]["frames"][0]))
        eye = np.eye(4, dtype=np.float32).reshape(16)
        meta = np.zeros((P, 18), np.float32)
        for f in range(n_frames):
            imgs = []
            for lane, s in enumerate(lanes):
                ok = lane < n_real and f < len(s["frames"])
                imgs.append(np.asarray(s["frames"][f]) if ok else zero_img)
                meta[lane, 0] = float(s["frame_ids"][f]) if ok else 0.0
                meta[lane, 1:17] = (np.asarray(s["T_wcs"][f], np.float32).reshape(16) if ok
                                    else eye)
                meta[lane, 17] = ok
            res = self.step(stores, logs, np.stack(imgs), meta, Ks, img_h, img_w)
            stores, logs = res.store, res.log
        return stores, logs

    def finalize(self, scenes: list[dict], stores: tracker.TrackStore, logs: tracker.FrameLog,
                 img_h: float, img_w: float) -> list[dict]:
        """Each real lane's scene end on the host, in JAX's order: drain the
        log, ``optim_process``, ``merge_process``, ``optim_process``."""
        outs = []
        for lane, s in enumerate(scenes):
            K = np.asarray(s["K"], np.float32)
            pipe = _FinalizeShim(self.cfg, self.device)
            pipe.init_sequence(K, img_h, img_w)
            seq = pipe.sequence
            seq["usable_frames"] = [int(f) for f in s["frame_ids"]]
            seq["T_wcs"] = [np.asarray(T, np.float32) for T in s["T_wcs"]]
            seq["P_cws"] = [K[:3, :3] @ np.linalg.inv(np.asarray(T, np.float64)
                                                      ).astype(np.float32)[:3, :]
                            for T in s["T_wcs"]]
            seq["store"] = tracker.lane_of(stores, lane)
            seq["log"] = tracker.lane_of(logs, lane)
            out = pipe.optim_process(pipe.tracks)
            out = pipe.optim_process(pipe.merge_process(out))
            out["overflow_report"] = pipe.overflow_report()
            outs.append(out)
        return outs


class _FinalizeShim(proc_mod.OdamPipeline):
    """OdamPipeline's host surface (tracks, optim, merge) without models: the
    lanes have already produced the device state."""

    def __init__(self, cfg: proc_mod.PipelineConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.sequence = None
