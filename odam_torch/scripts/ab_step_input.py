"""A/B of the step's frame-transport forms, the frames already on the device.

    python -m odam_torch.scripts.ab_step_input [--img_h 800 --img_w 1071]

Counterpart of ``scripts/ab_step_input.py``: the same ``OdamPipeline`` step
(seeded weights at full width, ``--dtype``) over device-resident frames in
each input form:

  float32  pre-normalized [H, W, 3] float32
  uint8    [H, W, 3] uint8, normalized in the step
  yuv420   (Y, UV) uint8 tuple, decoded and normalized in the step

Each form runs a new sequence: two warm frames, then ``ODAM_AB_PASSES``
(default 5) passes of ``--frames`` frames, each closed by a synchronize;
frames/s a pass, the median, and the difference against float32.  The
float32 frames are normalized on the host in float32, the step's own
arithmetic, so float32 and uint8 give the step the same image; YUV 4:2:0
halves the chroma.  The forms must give the same tracks: the last line says
whether each form's observation log holds the same track ids as float32's
(JAX's tool does not check it).  Runs on the card unless ``--device cpu``;
the first line names the device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.ab_step_input",
                                 description="Frames/s of the step by input form "
                                             "(PyTorch port).")
    ap.add_argument("--img_h", type=int, default=800)
    ap.add_argument("--img_w", type=int, default=1071)
    ap.add_argument("--frames", type=int, default=40, help="frames a timed pass")
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def pose(f: int) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    phi = 0.02 * f
    T[:3, :3] = np.array([[np.cos(phi), -np.sin(phi), 0],
                          [np.sin(phi), np.cos(phi), 0], [0, 0, 1]], np.float32)
    T[:3, 3] = [0.05 * f, 0, 1.4]
    return T


def main(argv: list[str] | None = None) -> dict:
    """Print each form's frames/s; return {form: [frames/s a pass]}, and
    whether every form's track ids equal float32's."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from ..data.loader import to_device
    from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, rgb_to_yuv420
    from ..models import associator as assoc_mod, detr as detr_mod
    from ..runtime import processor as proc_mod
    from ..utils.metrics import device_banner, synchronize

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    banner = device_banner(dev)
    print(f"device: {banner}", flush=True)
    img_h, img_w = args.img_h, args.img_w
    n_frames = args.frames
    n_passes = int(os.environ.get("ODAM_AB_PASSES", "5"))
    dtype = DTYPES[args.dtype]

    detr = detr_mod.build_detr(detr_mod.DETRConfig(dtype=dtype), seed=0, device=dev)
    assoc = assoc_mod.build_associator(assoc_mod.AssociatorConfig(dtype=dtype), seed=1,
                                       device=dev)
    pcfg = proc_mod.PipelineConfig(detect_threshold=0.0, score_threshold=0.0)
    pipe = proc_mod.OdamPipeline(detr, assoc, pcfg, device=dev)
    K = np.array([[1170.0 * img_w / 1296, 0, img_w / 2],
                  [0, 1170.0 * img_h / 968, img_h / 2],
                  [0, 0, 1]], np.float32)

    rng = np.random.default_rng(0)
    rgb_u8 = [rng.integers(0, 256, size=(img_h, img_w, 3), dtype=np.uint8) for _ in range(4)]
    forms = {
        "float32": [to_device(((f.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
                              .astype(np.float32), dev) for f in rgb_u8],
        "uint8": [to_device(f, dev) for f in rgb_u8],
        "yuv420": [to_device(rgb_to_yuv420(f), dev) for f in rgb_u8],
    }

    results, ids = {}, {}
    for name, frames in forms.items():
        pipe.init_sequence(K, img_h, img_w)
        t0 = time.perf_counter()
        for f in range(2):
            pipe.process_frame(frames[f % 4], f, pose(f))
        synchronize(dev)
        print(f"{name}: warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        fps = []
        for rep in range(n_passes):
            t0 = time.perf_counter()
            for f in range(2 + rep * n_frames, 2 + (rep + 1) * n_frames):
                pipe.process_frame(frames[f % 4], f, pose(f))
            synchronize(dev)
            fps.append(n_frames / (time.perf_counter() - t0))
        results[name] = fps
        n_run = 2 + n_passes * n_frames
        ids[name] = pipe.sequence["log"].ids[:n_run].cpu().numpy()
        print(f"{name}: median {np.median(fps):.2f} fps "
              f"[{', '.join(f'{x:.1f}' for x in fps)}]", flush=True)

    base = np.median(results["float32"])
    for name, fps in results.items():
        print(f"{name}: {np.median(fps):.2f} fps "
              f"({100 * (np.median(fps) / base - 1):+.1f}% vs float32)")
    same = {name: bool(np.array_equal(x, ids["float32"])) for name, x in ids.items()}
    print(f"track ids equal float32's: {same}", flush=True)
    return {"device": banner, "fps": results, "ids_equal_float32": same,
            "frames_per_pass": n_frames, "passes": n_passes}


if __name__ == "__main__":
    main()
