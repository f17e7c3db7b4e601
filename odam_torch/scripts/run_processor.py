"""End-to-end pipeline CLI: detect -> associate -> map over ScanNet scenes.

    python -m odam_torch.scripts.run_processor --config_path configs/detr_scan_net.yaml \\
        --use_prior --representation super_quadric --out_dir ./result/test

Counterpart of ``scripts/run_processor.py`` with the same flags, defaults
and output: per scene, a pickle ``{tracks, bboxes_qc, bboxes_dl, quadrics}``
of numpy arrays (``quadrics``: SQParams of numpy arrays) at
``<out_dir>/<scene>/<scene>``.  The online mode runs the per-frame step,
then ``optim_process``, ``merge_process`` and ``optim_process`` again;
``--offline`` detects in batches of ``--detect_batch`` frames first and
then tracks over the cached detections.  ``--profile fast`` selects the
greedy decode and the closed-form track boxes, ``--solver lm`` the LM
mapping solve with its Adam fallback, ``--device_resize`` ships raw uint8
frames and resizes them on the device.  ``--scene_parallel P`` runs P
scenes at once as lanes of one batched step
(:mod:`odam_torch.runtime.scene_parallel`), each group of P scenes to the
same pickles; as in JAX, it takes precedence over ``--offline``, and its
frames are resized on the host to uint8 (PIL bilinear) and normalized on
the device, so ``--device_resize`` does nothing there.

Under a launcher (``python -m torch.distributed.run --nproc_per_node W -m
odam_torch.scripts.run_processor --scene_parallel P ...``) the lanes run
over d = max(d | P, d <= W) ranks, P / d lanes each, as JAX's CLI picks its
mesh (:mod:`odam_torch.runtime.scene_parallel`).  Rank 0 decides which
scenes ``--resume`` leaves and writes the pickles; the ranks meet after
each group.  ``--dist_backend`` is ``nccl`` (a card a rank, the default on
the card) or ``gloo`` (the CPU's default; ranks may share a card).  More
than one rank needs ``--scene_parallel``.

It runs on the card unless ``--device cpu``.  ``--dtype`` defaults to
bfloat16, as the JAX CLI does: the models compute in bf16 with float32
parameters, and everything after them (postprocess, association scores,
Sinkhorn, tracking, mapping) runs in float32.  TF32 is off in both dtypes,
so float32 stays float32 on the card.  ``--use_pallas`` selects the
attention kernels (``use_kernels``): ``on`` and ``auto`` launch them on the
card, and on the CPU run the wrappers' plain versions, so a CPU run takes
the card's routing call for call; ``off`` takes the plain path of
``mha_core``, as JAX's ``off`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import torch

from .. import config as config_mod
from ..data import loader, scannet, transforms

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.scripts.run_processor",
        description="Detect, associate and map ScanNet scenes on the card (PyTorch port).")
    ap.add_argument("--config_path", default="configs/detr_scan_net.yaml")
    ap.add_argument("--detect_threshold", default=0.6, type=float)
    ap.add_argument("--min_views", default=10, type=int,
                    help="optimizer view gate: tracks with fewer valid views keep their "
                         "detector-average box (eval twin: eval_scan2cad --min_views)")
    ap.add_argument("--attach_threshold", default=0.8, type=float,
                    help="Sinkhorn attach/new-track score gate")
    ap.add_argument("--robust_init", action="store_true",
                    help="median (vs the reference's mean) track aggregation for the mapping "
                         "init and the detector-average fallback box")
    ap.add_argument("--use_prior", action="store_true")
    ap.add_argument("--no_code", action="store_true")
    ap.add_argument("--representation", default="super_quadric",
                    help="[cube, super_quadric, quadric]")
    ap.add_argument("--out_dir", default="./result/test")
    ap.add_argument("--scans_root", default="./data/ScanNet/scans")
    ap.add_argument("--sequences", default=None,
                    help="file with one scene id per line (default: all scenes)")
    ap.add_argument("--detector_ckpt", default="./experiments/detector.pth",
                    help="the reference's .pth (unpickled: load only trusted files), a "
                         "Flax tree as .npz (tests/test_torch_checkpoints.py writes them), "
                         "or a ckpt_<step> directory of the port's train scripts; "
                         "a missing file means seeded weights")
    ap.add_argument("--associator_ckpt", default="./experiments/associator.pth",
                    help="as --detector_ckpt")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="the models' compute dtype (parameters stay float32)")
    ap.add_argument("--max_frames", default=None, type=int)
    ap.add_argument("--resume", action="store_true",
                    help="skip scenes whose output already exists")
    ap.add_argument("--offline", action="store_true",
                    help="batched-ahead detection + streamed association")
    ap.add_argument("--detect_batch", type=int, default=8)
    ap.add_argument("--device_resize", action="store_true",
                    help="ship raw uint8 frames and resize+normalize on the device")
    ap.add_argument("--prefetch_workers", type=int, default=2)
    ap.add_argument("--use_pallas", choices=["auto", "on", "off"], default="auto",
                    help="the attention kernels (auto: on; on the CPU the wrappers run "
                         "their plain versions)")
    ap.add_argument("--profile", choices=["parity", "fast"], default="parity",
                    help="parity: exact Hungarian + sampled track projection; fast: greedy "
                         "decode + closed-form projection")
    ap.add_argument("--solver", choices=["adam", "lm"], default="adam",
                    help="mapping solver: adam (reference-exact) or lm (LM with automatic "
                         "Adam fallback)")
    ap.add_argument("--decode", choices=["profile", "exact", "greedy"], default="profile",
                    help="association decode (overrides --profile)")
    ap.add_argument("--track_bbox", choices=["profile", "sampled", "exact"], default="profile",
                    help="track re-projection mode (overrides --profile)")
    ap.add_argument("--max_objs", type=int, default=64,
                    help="mapping-stage object-slot capacity")
    ap.add_argument("--max_views", type=int, default=256,
                    help="mapping-stage view-slot capacity per object")
    ap.add_argument("--window", type=int, default=100,
                    help="associator track-history window")
    ap.add_argument("--short_side", type=int, default=800,
                    help="inference resize: shorter side")
    ap.add_argument("--max_size", type=int, default=1333,
                    help="inference resize: longest-side cap")
    ap.add_argument("--shard", default=None,
                    help="'i/n': process scenes i, i+n, i+2n, ...")
    ap.add_argument("--scene_parallel", type=int, default=0,
                    help="run P scenes at once as lanes of one batched step on the device "
                         "(takes precedence over --offline; frames resized on the host)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                    help="under a launcher: the process group's backend (default nccl on "
                         "the card, gloo on the CPU)")
    return ap


def load_weights(path: str, what: str, from_pth) -> dict | None:
    """A Flax-layout tree from ``path``, or None (seeded init) when there is
    no such file: ``.npz`` is read as a Flax tree, any other file as a
    reference ``.pth`` converted by ``from_pth(state_dict)``."""
    from ..models import convert, porting
    from ..utils import checkpoint

    if path and os.path.isdir(path):
        if checkpoint.latest_path(path) is not None:
            print(f"loaded {what} weights from the checkpoint {path}")
            return checkpoint.restore(path)[0]
        sys.exit(f"{what} checkpoint {path} is an orbax directory, which the port does not "
                 "read: convert it to .npz (tests/test_torch_checkpoints.py shows how)")
    if path and os.path.isfile(path):
        print(f"loaded {what} weights from {path}")
        if path.endswith(".npz"):
            return convert.load_flax_npz(path)
        return from_pth(porting.load_torch_checkpoint(path))
    print(f"WARNING: no {what} checkpoint; using random init", file=sys.stderr)
    return None


def build_models(cfg, detector_ckpt: str, associator_ckpt: str, decode: str, device,
                 dtype: torch.dtype = torch.float32, use_kernels: bool = True):
    from ..models import associator as assoc_mod
    from ..models import detr as detr_mod
    from ..models import porting

    dcfg = detr_mod.DETRConfig.from_cfg(cfg, dtype=dtype, use_kernels=use_kernels)
    acfg = dataclasses.replace(
        assoc_mod.AssociatorConfig.from_cfg(cfg, dtype=dtype, use_kernels=use_kernels),
        decode=decode)
    detr = detr_mod.build_detr(dcfg, device=device, flax_params=load_weights(
        detector_ckpt, "detector",
        lambda sd: porting.convert_detr(sd, enc_layers=dcfg.enc_layers,
                                        dec_layers=dcfg.dec_layers)))
    assoc = assoc_mod.build_associator(acfg, device=device, flax_params=load_weights(
        associator_ckpt, "associator",
        lambda sd: porting.convert_associator(sd, d_model=acfg.descriptor_dim,
                                              num_heads=acfg.num_heads,
                                              n_gnn=len(acfg.gnn_layers),
                                              n_fuser=len(acfg.self_gnn_layers))))
    return detr, assoc


def scene_header(index, seq_id: str, args) -> tuple[list[str], np.ndarray, np.ndarray,
                                                    int, int]:
    """(frame names, K scaled to the resize, axis alignment, resized height,
    resized width) of one scene, the first ``--max_frames`` frames."""
    from PIL import Image

    K = scannet.read_intrinsic(index.intrinsic_path(seq_id))[:3, :3]
    axis_align = scannet.read_axis_align(index.meta_path(seq_id))
    frames = index.frame_names(seq_id)
    if args.max_frames:
        frames = frames[: args.max_frames]
    first = np.asarray(Image.open(index.image_path(seq_id, frames[0])))
    ih, iw = transforms.target_size(*first.shape[:2], short_side=args.short_side,
                                    max_size=args.max_size)
    K_scaled = K.copy()
    K_scaled[0] *= iw / first.shape[1]
    K_scaled[1] *= ih / first.shape[0]
    return frames, K_scaled, axis_align, ih, iw


def run_scene(pipe, index, seq_id: str, args, detector=None) -> tuple[dict, int, int]:
    """One scene, frames to the final solve: (result, frames, tracks).

    Online: the per-frame step, then optim -> merge -> optim.  Offline
    (``detector`` given, ``pipe`` a CachedDetectionPipeline): every usable
    frame is loaded, detected in batches, then tracked and mapped."""
    frames, K_scaled, axis_align, ih, iw = scene_header(index, seq_id, args)

    if args.device_resize:
        preprocess = None         # raw uint8; resize and normalize in the step
    else:
        preprocess = lambda rgb: transforms.preprocess_image(rgb, ih, iw)  # noqa: E731
    frame_iter = loader.scene_frame_loader(index, seq_id, frames, preprocess,
                                           num_workers=args.prefetch_workers)
    usable = (item for item in frame_iter if not np.isnan(item[2]).any())  # NaN poses skipped
    if detector is not None:
        from ..runtime import offline

        images, fids, poses = [], [], []
        for fid, img, T_cw in usable:
            images.append(img)
            fids.append(fid)
            poses.append(axis_align @ np.linalg.inv(T_cw))
        out = offline.run_scene_offline(detector, pipe, images, fids, poses, K_scaled,
                                        ih, iw)
        return out, len(fids), len(out["tracks"])

    pipe.init_sequence(K_scaled, ih, iw)
    n_frames = 0
    for fid, img, T_cw in loader.device_prefetch(usable, pipe.device):
        pipe.process_frame(img, fid, axis_align @ np.linalg.inv(T_cw))
        n_frames += 1
    n_tracks = len(pipe.tracks)
    out = pipe.optim_process(pipe.tracks)
    out = pipe.optim_process(pipe.merge_process(out))
    return out, n_frames, n_tracks


class LazyFrames:
    """A scene's frames, read and resized (PIL bilinear, to uint8) when
    indexed: the lanes read each frame once, in order, so a group holds P
    frames at a time and not P scenes."""

    def __init__(self, index, seq_id: str, names: list[str], ih: int, iw: int):
        self.index = index
        self.seq_id = seq_id
        self.names = names
        self.size = (iw, ih)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.index.image_path(self.seq_id, self.names[i]))
        return np.asarray(img.resize(self.size, Image.BILINEAR))


def scene_inputs(index, seq_id: str, args) -> dict:
    """One scene as the lanes take it: lazily resized uint8 frames, the
    frame ids and world poses of the frames with a finite pose, K scaled to
    the resize, and the resized (height, width)."""
    names, K_scaled, axis_align, ih, iw = scene_header(index, seq_id, args)
    fids, T_wcs, keep = [], [], []
    for name in names:
        T_cw = scannet.read_extrinsic(index.pose_path(seq_id, name))
        if np.isnan(T_cw).any():
            continue                     # NaN poses skipped
        keep.append(name)
        fids.append(int(name))
        T_wcs.append(axis_align @ np.linalg.inv(T_cw))
    return {"frames": LazyFrames(index, seq_id, keep, ih, iw), "frame_ids": fids,
            "T_wcs": T_wcs, "K": K_scaled, "seq_id": seq_id, "size": (ih, iw)}


def run_scene_parallel(args, index, scene_list: list[str], runner) -> None:
    """``--scene_parallel P``: the scenes in groups of P through ``runner``
    (a :class:`odam_torch.runtime.scene_parallel.SceneParallelRunner`), each
    group's pickles written as the serial loop writes them, by rank 0."""
    from ..parallel import distributed

    pending = []
    for seq_id in scene_list:
        if args.resume and os.path.exists(os.path.join(args.out_dir, seq_id, seq_id)):
            print(f"skipping (resume): {seq_id}")
        else:
            pending.append(seq_id)
    pending = distributed.broadcast_object(pending)     # rank 0's view of the files
    P = runner.n_lanes
    for start in range(0, len(pending), P):
        group = [scene_inputs(index, seq_id, args) for seq_id in pending[start:start + P]]
        ih, iw = group[-1]["size"]
        t0 = time.time()
        outs = runner.run_scenes(group, float(ih), float(iw))
        seconds = time.time() - t0
        n_frames = sum(len(s["frame_ids"]) for s in group)
        print(f"group of {len(group)} scenes: {n_frames} frames in {seconds:.1f}s "
              f"({n_frames / max(seconds, 1e-6):.1f} fps aggregate)")
        for s, out in zip(group, outs):
            seq_id = s["seq_id"]
            if distributed.is_main_process():
                os.makedirs(os.path.join(args.out_dir, seq_id), exist_ok=True)
                with open(os.path.join(args.out_dir, seq_id, seq_id), "wb") as f:
                    pickle.dump({k: out[k] for k in ("tracks", "bboxes_qc", "bboxes_dl",
                                                     "quadrics")}, f)
            print(f"  {seq_id}: {len(out['tracks'])} tracks")
        distributed.barrier()


def pipeline_config(args):
    """The PipelineConfig that the flags select."""
    from ..runtime import processor as proc_mod

    track_bbox = args.track_bbox if args.track_bbox != "profile" else (
        "exact" if args.profile == "fast" else "sampled")
    return proc_mod.PipelineConfig(
        detect_threshold=args.detect_threshold,
        score_threshold=args.attach_threshold,
        representation=args.representation,
        use_prior=args.use_prior,
        no_code=args.no_code,
        resize_on_device=args.device_resize,
        track_bbox_mode=track_bbox,
        optim_solver=args.solver,
        min_views=args.min_views,
        robust_init=args.robust_init,
        max_objs=args.max_objs,
        max_views=args.max_views,
        window=args.window,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    fast = args.profile == "fast"
    decode = args.decode if args.decode != "profile" else ("greedy" if fast else "exact")
    from ..parallel import distributed, mesh as mesh_mod

    device = distributed.init_distributed(backend=args.dist_backend, device=args.device)
    world = distributed.process_count()
    if world > 1:
        if not args.scene_parallel:
            raise SystemExit(f"run_processor on {world} ranks needs --scene_parallel P")
        distributed.main_process_only_print()
    if device.type == "cuda":
        # float32 means float32 in both dtypes (the stages after the models
        # are float32): cuDNN runs convolutions in TF32 by default
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from ..runtime import offline
    from ..runtime import processor as proc_mod

    cfg = config_mod.merge_cfg([args.config_path])
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    detr, assoc = build_models(cfg, args.detector_ckpt, args.associator_ckpt, decode, device,
                               dtype, use_kernels=args.use_pallas != "off")
    pcfg = pipeline_config(args)

    sequences = None
    if args.sequences:
        with open(args.sequences) as f:
            sequences = f.read().splitlines()
    index = scannet.SceneIndex(args.scans_root, sequences)
    scene_list = index.sequences
    if args.shard:
        i, n = (int(x) for x in args.shard.split("/"))
        scene_list = scene_list[i::n]
        print(f"shard {i}/{n}: {len(scene_list)} scenes")

    if args.scene_parallel:
        from ..runtime import scene_parallel

        P, mesh = args.scene_parallel, None
        if world > 1:
            d = max(d for d in range(1, min(P, world) + 1) if P % d == 0)
            mesh = mesh_mod.make_mesh({"dp": d}, device=device)
            print(f"scene lanes over {d} of {world} ranks, {P // d} a rank")
        runner = scene_parallel.SceneParallelRunner(detr, assoc, pcfg, P, device=device,
                                                    mesh=mesh)
        run_scene_parallel(args, index, scene_list, runner)
        return 0

    detector = None
    if args.offline:
        detector = offline.BatchedDetector(detr, pcfg, batch_size=args.detect_batch,
                                           device=device)
        pipe = offline.CachedDetectionPipeline(assoc, pcfg, device=device)
    else:
        pipe = proc_mod.OdamPipeline(detr, assoc, pcfg, device=device)

    for seq_id in scene_list:
        out_dir = os.path.join(args.out_dir, seq_id)
        out_path = os.path.join(out_dir, seq_id)
        if args.resume and os.path.exists(out_path):
            print(f"skipping (resume): {seq_id}")
            continue
        print(f"processing: {seq_id}")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        out, n_frames, n_tracks = run_scene(pipe, index, seq_id, args, detector)
        fps = n_frames / max(time.time() - t0, 1e-6)
        print(f"  {n_frames} frames, {fps:.1f} fps, {n_tracks} tracks")
        with open(out_path, "wb") as f:
            pickle.dump({k: out[k] for k in ("tracks", "bboxes_qc", "bboxes_dl", "quadrics")}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
