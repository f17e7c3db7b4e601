"""Train the tiny rehearsal detector and associator from scratch.

    python -m odam_torch.examples.cli_rehearsal.train <mode> <seg> <steps> <ckpt> [--device cpu]

Counterpart of ``examples/cli_rehearsal/train.py``, with its modes
(``detector``, ``detector_frozen``, ``associator``), crash-isolated segments
and environment: ``ODAM_HARD=1`` (the hard split), ``ODAM_LR``,
``ODAM_DECAY_STEPS`` (cosine decay), ``ODAM_TRAIN_BATCH``, ``ODAM_BANK``,
``ODAM_WINDOW`` and ``ODAM_STREAM_FRAMES``.  For example::

    for s in 0 1 2 3 4 5 6 7 8 9; do
      python -m odam_torch.examples.cli_rehearsal.train detector $s 400 rehearsal_detr_ckpt
    done
    python -m odam_torch.examples.cli_rehearsal.train associator 0 400 rehearsal_assoc_ckpt

Each segment starts from ``<ckpt>`` when it exists (else the port's seeded
init) with a fresh optimizer, banks the parameters every ``ODAM_BANK`` steps
and saves them at the end, as checkpoint directories of
:mod:`odam_torch.utils.checkpoint` (``params.npz`` a Flax tree, which
``run_processor --detector_ckpt`` reads) whose meta carries the segment's
``global_step``.  The detector modes check that step against the segment
(:func:`check_provenance`).  The models train on the plain attention path.

The associator trains at the PIPELINE's input geometry — window 100,
detections padded to 30 (padded det rows participate in attention, matching
the reference collater) — so inference is in-distribution.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch import nn

from .. import resolve
from ...data.datasets import build_association_sample, pack_targets
from ...models import associator as assoc_mod, convert, criterion as crit_mod
from ...models import detr as detr_mod, matcher as matcher_mod, training as train_mod
from ...scripts.train_associator import BATCH_KEYS
from ...utils import checkpoint
from .common import IMG, SCENES, gt_world_tracks, make_assoc, make_detr, norm, scene_views

def _hard(hard: bool | None) -> bool:
    """``hard``, or without it ``ODAM_HARD=1``."""
    return os.environ.get("ODAM_HARD") == "1" if hard is None else hard


def _train_views(hard: bool | None = None):
    """(img, rows) training views — standard scenes, or the hard split's
    held-out layout seeds (eval scenes use different seeds, so
    generalization is over layouts, not camera phases alone)."""
    views = []
    if _hard(hard):
        from .hard import TRAIN_SEEDS, hard_scene_views

        for seed in TRAIN_SEEDS:
            for phase in (0.0, 0.5):
                for _, _, img, rows, _ in hard_scene_views(seed, phase=phase):
                    if len(rows):
                        views.append((img, rows))
    else:
        for scene_id in SCENES:
            # two camera rings offset from the on-disk eval ring (phase 0.0)
            for phase in (0.3, 0.65):
                for _, _, img, rows in scene_views(scene_id, phase=phase):
                    if len(rows):
                        views.append((img, rows))
    return views


def _lr(seg: int, steps: int, start_it: int = 0, offset: bool = True):
    """``ODAM_LR``, cosine-decayed over ``ODAM_DECAY_STEPS`` when set.  A
    segment resumes mid-schedule: segment s of n steps starts at global step
    s*n (+ the banked step on a mid-segment resume), while its fresh
    optimizer counts from 0 (``offset=False``: JAX's frozen mode, which
    restarts the schedule)."""
    lr = float(os.environ.get("ODAM_LR", "5e-4"))
    decay_steps = int(os.environ.get("ODAM_DECAY_STEPS", "0"))
    if not decay_steps:
        return lr
    base = train_mod.cosine_decay_schedule(lr, decay_steps, alpha=0.02)
    shift = seg * steps + start_it if offset else 0
    return lambda count: base(count + shift)


def check_provenance(ckpt: str, seg: int, steps: int) -> int:
    """The step inside segment ``seg`` at which training resumes from
    ``ckpt``'s ``global_step``: 0 at the segment's start boundary, the banked
    step after a mid-segment bank.  A checkpoint of any other segment raises
    SystemExit: a wrong seg would train with a wrong cosine offset.  A
    checkpoint without the meta trusts ``seg``."""
    meta = checkpoint.load_meta(ckpt)
    if meta is None or "global_step" not in meta:
        print(f"WARNING: {ckpt} carries no global_step meta; trusting seg={seg}")
        return 0
    at = int(meta["global_step"])
    if at // steps != seg and at != seg * steps:
        raise SystemExit(
            f"checkpoint {ckpt} is at global step {at}; segment "
            f"{seg} of {steps}-step segments expects "
            f"[{seg * steps}, {(seg + 1) * steps}). Resume with seg {at // steps}.")
    start_it = at - seg * steps
    if start_it:
        print(f"mid-segment bank: resuming segment {seg} at step {start_it}/{steps}")
    return start_it


def _meta(seg: int, steps: int, global_step: int) -> dict:
    return {"global_step": global_step, "seg": seg, "seg_steps": steps}


def _targets(rows, max_objects: int, dev) -> crit_mod.Targets:
    return crit_mod.Targets(*[torch.from_numpy(x).to(dev) for x in pack_targets(rows,
                                                                                 max_objects)])


def train_detector(seg: int, steps: int, ckpt: str, device: str = "cuda",
                   hard: bool | None = None) -> dict:
    """Full end-to-end detector training (backbone included).

    HARD mode trains the lightweight trainable backbone (TinyBackbone) on
    freshly generated layouts every step (``hard.hard_random_view``).
    Returns the segment's last loss, its steps and seconds.
    """
    dev = resolve(device)
    hard = _hard(hard)
    if hard:
        from .hard import IMG as img_size, hard_random_view

        cfg = make_detr(16, backbone_stage=3, backbone="tiny", use_kernels=False)
    else:
        img_size = IMG
        views = _train_views(False)
        cfg = make_detr(12, use_kernels=False)
    params, start_it = None, 0
    if checkpoint.latest_path(ckpt):
        start_it = check_provenance(ckpt, seg, steps)
        params = checkpoint.restore(ckpt)[0]
        print(f"resumed from {ckpt}")
    model = detr_mod.build_detr(cfg, flax_params=params, seed=0, device=dev)
    lr = _lr(seg, steps, start_it)
    tcfg = train_mod.DetrTrainConfig(
        lr=lr, lr_backbone=lr, clip_norm=5.0, weight_decay=0.0,
        criterion=crit_mod.CriterionConfig(num_classes=cfg.num_classes))
    state = train_mod.init_train_state(model, train_mod.make_detr_optimizer(model, tcfg))
    step_fn = train_mod.make_detr_train_step(tcfg)
    # fresh layouts every step: a partial-segment resume just needs a data
    # stream disjoint from the already-trained prefix, not a replay of it
    rng = np.random.default_rng(seg if not start_it else seg * 100003 + start_it)
    B = int(os.environ.get("ODAM_TRAIN_BATCH", "8"))
    bank = int(os.environ.get("ODAM_BANK", "150"))
    t0 = time.time()
    m = None
    for it in range(start_it, steps):
        if hard:
            batch = []
            while len(batch) < B:
                img, rows = hard_random_view(rng)
                if len(rows):
                    batch.append((img, rows))
            imgs = np.stack([norm(v[0]) for v in batch])
            targets = _targets([v[1] for v in batch], 12, dev)
        else:
            idx = rng.integers(0, len(views), B)
            imgs = np.stack([norm(views[i][0]) for i in idx])
            targets = _targets([views[i][1] for i in idx], 8, dev)
        state.step = seg * 10000 + it   # JAX's dropout key, jax.random.key(seg*10000+it)
        m = step_fn(state, torch.from_numpy(imgs).to(dev), targets)
        if (it + 1) % bank == 0:
            checkpoint.save(ckpt, convert.state_dict_to_flax(model),
                            meta=_meta(seg, steps, seg * steps + it + 1))
            print(f"  banked at step {it + 1}, loss {float(m['total']):.2f}", flush=True)
    total = float(m["total"]) if m is not None else float("nan")   # forces completion
    seconds = time.time() - t0
    checkpoint.save(ckpt, convert.state_dict_to_flax(model),
                    meta=_meta(seg, steps, (seg + 1) * steps))
    print(f"detector segment {seg}: {steps} steps in {seconds:.0f}s, loss {total:.2f}")
    return {"mode": "detector", "loss": total, "steps": steps - start_it, "seconds": seconds}


class _DETRHead(nn.Module):
    """Post-backbone DETR (transformer + heads) over cached features.

    Its parameter names are those of :class:`odam_torch.models.detr.DETR`
    (transformer, input_proj, query_embed, class_embed, *_embed), so its
    state_dict grafts into the full model's for inference (and, through
    :mod:`odam_torch.models.convert`, into JAX's tree, whose head has the
    same paths).  Frozen-(random)-backbone training is the limit case of the
    reference's 0.1x backbone lr.
    """

    def __init__(self, cfg: detr_mod.DETRConfig):
        super().__init__()
        full = detr_mod.DETR(cfg)
        self.config = cfg
        for name, child in full.named_children():
            if name != "backbone":
                self.add_module(name, child)
        self.query_embed = full.query_embed

    def forward(self, feats: torch.Tensor) -> dict:
        """``feats`` [B, fh, fw, C] (JAX's layout) -> DETR's outputs."""
        from ...models import position

        c = self.config
        B, fh, fw, _ = feats.shape
        feat_mask = torch.zeros((B, fh, fw), dtype=torch.bool, device=feats.device)
        pos = position.sine_position_encoding(feat_mask, num_pos_feats=c.hidden_dim // 2,
                                              dtype=c.dtype)
        src = self.input_proj(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        hs, _ = self.transformer(src, feat_mask, self.query_embed, pos)
        heads = {
            "pred_logits": self.class_embed(hs),
            "pred_boxes": torch.sigmoid(self.bbox_embed(hs)),
            "pred_offset": self.offset_embed(hs),
            "pred_angle": self.angle_embed(hs),
            "pred_size": self.size_embed(hs),
            "pred_depth": self.depth_embed(hs),
        }
        out = {k: v[-1] for k, v in heads.items()}
        out["aux_outputs"] = [{k: v[i] for k, v in heads.items()} for i in range(hs.shape[0] - 1)]
        return out


def feature_cache_path(ckpt: str, stage: int, hard: bool) -> str:
    """The frozen backbone's feature cache beside ``ckpt``, named per split and
    stage (``_torch``: the port's seeded backbone is not JAX's)."""
    name = f"rehearsal_feats_hard_s{stage}_torch.npz" if hard else "rehearsal_feats_torch.npz"
    return os.path.join(os.path.dirname(os.path.abspath(ckpt)), name)


def backbone_features(model: detr_mod.DETR, views: list, batch: int = 16) -> np.ndarray:
    """The DETR's backbone stage over every view: [V, fh, fw, C] float32."""
    dev = next(model.parameters()).device
    stage = model.config.backbone_stage
    outs = []
    with torch.no_grad():
        for start in range(0, len(views), batch):
            imgs = torch.from_numpy(np.stack([norm(v[0]) for v in views[start:start + batch]]))
            f = model.backbone(imgs.to(dev).permute(0, 3, 1, 2))[stage]
            outs.append(f.permute(0, 2, 3, 1).float().cpu().numpy())
    return np.concatenate(outs)


def train_detector_frozen(seg: int, steps: int, ckpt: str, device: str = "cuda",
                          hard: bool | None = None) -> dict:
    """Train transformer+heads on cached frozen-backbone features."""
    dev = resolve(device)
    hard = _hard(hard)
    cfg = make_detr(16 if hard else 12, backbone_stage=3 if hard else 4, use_kernels=False)
    params = None
    if checkpoint.latest_path(ckpt):
        params = checkpoint.restore(ckpt)[0]
        print(f"resumed from {ckpt}")
    full = detr_mod.build_detr(cfg, flax_params=params, seed=0, device=dev)

    # cache backbone features for every train view (one-time inference)
    feat_cache = feature_cache_path(ckpt, cfg.backbone_stage, hard)
    views = _train_views(hard)
    if os.path.exists(feat_cache):
        with np.load(feat_cache) as z:
            feats = z["feats"]
    else:
        feats = backbone_features(full, views)
        np.savez(feat_cache, feats=feats)
        print(f"cached {feats.shape} backbone features")

    head = _DETRHead(cfg).to(dev)
    head.load_state_dict({k: v for k, v in full.state_dict().items()
                          if not k.startswith("backbone.")})
    head.train()
    tcfg = crit_mod.CriterionConfig(num_classes=cfg.num_classes)
    matcher = matcher_mod.HungarianMatcher(tcfg.matcher)
    opt = train_mod.OptaxAdam(
        {"main": (_lr(seg, steps, offset=False),
                  [(convert.flax_path(head, k), p) for k, p in head.named_parameters()])},
        clip_norm=5.0)

    def merged() -> dict:
        full.load_state_dict(head.state_dict(), strict=False)
        return convert.state_dict_to_flax(full)

    rng = np.random.default_rng(seg)
    B = int(os.environ.get("ODAM_TRAIN_BATCH", "8"))
    bank = int(os.environ.get("ODAM_BANK", "500"))
    feats_dev = torch.from_numpy(feats).to(dev)
    t0 = time.time()
    total = None
    for it in range(steps):
        idx = rng.integers(0, len(views), B)
        targets = _targets([views[i][1] for i in idx], 12 if hard else 8, dev)
        for p in opt.parameters():
            p.grad = None
        with torch.enable_grad():
            total, _ = crit_mod.set_criterion(head(feats_dev[torch.from_numpy(idx).to(dev)]),
                                              targets, tcfg, matcher=matcher)
            total.backward()
        opt.step()
        total = total.detach()
        if (it + 1) % bank == 0:
            checkpoint.save(ckpt, merged(), meta=_meta(seg, steps, seg * steps + it + 1))
            print(f"  banked at step {it + 1}, loss {float(total):.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    loss = float(total) if total is not None else float("nan")
    seconds = time.time() - t0
    checkpoint.save(ckpt, merged(), meta=_meta(seg, steps, (seg + 1) * steps))
    print(f"frozen-head segment {seg}: {steps} steps in {seconds:.0f}s, loss {loss:.2f}")
    return {"mode": "detector_frozen", "loss": loss, "steps": steps, "seconds": seconds}


def _ghost_rows(fid: float, T_wc: np.ndarray, rng: np.random.Generator,
                rate: float = 0.7) -> np.ndarray | None:
    """0-2 transient false-positive detection rows (82-dim) for one frame.

    Each ghost is a geometrically self-consistent detection of an object
    that does not exist — fresh random geometry every frame, so no two
    ghosts are the same object and the dustbin target is always correct
    supervision (a persistent ghost would wrongly teach non-attachment of
    consistent observations).
    """
    from .common import box_corners_np
    from .hard import CLASS_DIMS, IMG as HIMG, K as HK

    if rng.random() > rate:
        return None
    rows = []
    for _ in range(int(rng.integers(1, 3))):
        cls = int(rng.integers(0, 8))
        dims = np.asarray(CLASS_DIMS[cls]) * rng.uniform(0.7, 1.3, 3)
        c = np.array([rng.uniform(-1.8, 1.8), rng.uniform(-1.8, 1.8), dims[2] / 2])
        yaw = float(rng.uniform(0, np.pi))
        T_cw = np.linalg.inv(T_wc)
        pc = box_corners_np(dims, yaw, c) @ T_cw[:3, :3].T + T_cw[:3, 3]
        if pc[:, 2].min() < 0.3:
            continue
        uv = pc @ HK.T
        uv = uv[:, :2] / uv[:, 2:]
        x0, y0 = uv.min(0)
        x1, y1 = uv.max(0)
        if min(x1, HIMG) - max(x0, 0) < 5 or min(y1, HIMG) - max(y0, 0) < 5:
            continue
        row = np.full((82,), -1.0, np.float32)
        row[0] = fid
        row[1] = cls
        row[2:6] = [x0, y0, x1, y1]
        row[6:9] = dims
        row[9:12] = c
        row[12] = yaw
        # Same score band as the (jittered) real rows: score must NOT
        # separate ghosts from real detections, or the model learns a
        # score->dustbin shortcut and rejects real low-score detections
        # at inference.
        row[13] = float(rng.uniform(0.6, 1.0))
        row[78:82] = row[2:6]
        rows.append(row)
    return np.stack(rows) if rows else None


def association_samples(hard: bool | None = None, seeds=None) -> list[dict]:
    """The associator's training samples, in JAX's order.  ``seeds`` cuts the
    hard split's layout seeds (default ``hard.TRAIN_SEEDS``, or their first
    two for a long stream)."""
    hard = _hard(hard)
    T, N, W = (16 if hard else 8), 30, int(os.environ.get("ODAM_WINDOW", "100"))
    if hard:
        from . import analyze_visibility as av
        from . import hard as hard_mod

        img_size = hard_mod.IMG
        # Domain-match the training stream to what the pipeline's associator
        # actually receives: 1. visibility-gate track rows with the
        # detectability criterion, so track histories have occlusion gaps;
        # 2. inject transient false-positive detections (ghost rows) that
        # must map to the dustbin.  ODAM_STREAM_FRAMES: orbit length of the
        # training streams (a long stream takes fewer layout seeds).
        stream_frames = int(os.environ.get("ODAM_STREAM_FRAMES",
                                           str(hard_mod.N_FRAMES_HARD)))
        long_stream = stream_frames != hard_mod.N_FRAMES_HARD
        if seeds is None:
            seeds = hard_mod.TRAIN_SEEDS[:2] if long_stream else hard_mod.TRAIN_SEEDS
        sources = []
        for seed in seeds:
            _, flags, _, _ = av.visible_flags(seed, n_frames=stream_frames)

            def keep(fid, inst, flags=flags):
                return bool(flags[fid, inst])

            for ns in range(2):
                tracks, poses = hard_mod.hard_gt_world_tracks(
                    seed, np.random.default_rng(ns), noise=0.05, keep=keep,
                    n_frames=stream_frames)
                # score jitter, matched to the ghost band
                srng = np.random.default_rng(1000 + seed * 10 + ns)
                for t in tracks:
                    t[:, 13] = srng.uniform(0.6, 1.0, len(t))
                sources.append((tracks, poses))
    else:
        img_size = IMG
        sources = [gt_world_tracks(scene_id, np.random.default_rng(ns), noise=0.03)
                   for scene_id in SCENES for ns in range(4)]
    samples = []
    ghost_rng = np.random.default_rng(17)
    for tracks, poses in sources:
        for fid, T_wc in poses.items():
            if fid == 0:
                continue
            extra = _ghost_rows(float(fid), T_wc, ghost_rng) if hard else None
            s = build_association_sample(tracks, float(fid), T, N, W, T_wc=T_wc,
                                         img_w=float(img_size), img_h=float(img_size),
                                         extra_dets=extra)
            if s is not None:
                P = 32 if hard else 16  # pad variable-length gt pairs
                pairs = np.zeros((P, 2), np.int32)
                valid = np.zeros((P,), bool)
                k = min(len(s["gt_pairs"]), P)
                pairs[:k] = s["gt_pairs"][:k]
                valid[:k] = True
                s["gt_pairs"], s["pair_valid"] = pairs, valid
                samples.append(s)
    return samples


def association_batches(samples: list[dict], B: int = 16):
    """JAX's batch stream: ``default_rng(7)`` picks B samples a step."""
    rng = np.random.default_rng(7)
    while True:
        idx = rng.integers(0, len(samples), B)
        yield {k: np.stack([samples[i][k] for i in idx]) for k in BATCH_KEYS}


def train_associator(seg: int, steps: int, ckpt: str, device: str = "cuda",
                     hard: bool | None = None) -> dict:
    dev = resolve(device)
    samples = association_samples(hard)
    print(f"{len(samples)} association samples")
    params = None
    if checkpoint.latest_path(ckpt):
        params = checkpoint.restore(ckpt)[0]
        print(f"resumed from {ckpt}")
    model = assoc_mod.build_associator(make_assoc(use_kernels=False), flax_params=params,
                                       seed=0, device=dev)
    opt = train_mod.make_assoc_optimizer(model, train_mod.AssocTrainConfig(lr=3e-4,
                                                                           clip_norm=1.0))
    state = train_mod.init_train_state(model, opt)
    step_fn = train_mod.make_assoc_train_step()
    batches = association_batches(samples)
    t0 = time.time()
    loss = None
    for _ in range(steps):
        b = next(batches)
        loss = step_fn(state, *[torch.from_numpy(b[k]).to(dev) for k in BATCH_KEYS])
    final = float(loss) if loss is not None else float("nan")
    seconds = time.time() - t0
    model.eval()
    checkpoint.save(ckpt, convert.state_dict_to_flax(model),
                    meta=_meta(seg, steps, (seg + 1) * steps))
    print(f"associator segment {seg}: {steps} steps in {seconds:.0f}s, nll {final:.3f}")
    return {"mode": "associator", "loss": final, "steps": steps, "seconds": seconds,
            "samples": len(samples)}


TRAINERS = {"detector": train_detector, "detector_frozen": train_detector_frozen,
            "associator": train_associator}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.cli_rehearsal.train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("mode", help="detector, detector_frozen; anything else trains the "
                                 "associator, as in JAX")
    ap.add_argument("seg", type=int)
    ap.add_argument("steps", type=int)
    ap.add_argument("ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    trainer = TRAINERS.get(args.mode, train_associator)
    return trainer(args.seg, args.steps, os.path.abspath(args.ckpt), args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
