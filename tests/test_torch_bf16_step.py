"""odam_torch's whole online step in bf16 against odam_tpu's on the CPU,
with the bar of ``tests/test_torch_bf16.py``: the port's bf16 error against
JAX's float32 is at most twice JAX bf16's plus 2^-8 on every float output,
and integer outputs (detections a frame, track ids) equal the port's own
float32 run."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from odam_torch.data.transforms import rgb_to_yuv420
from odam_torch.models import associator as t_assoc
from odam_torch.models import detr as t_detr
from odam_torch.runtime import processor as t_proc
from odam_torch.runtime import tracker as t_trk
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import detr as j_detr
from odam_tpu.runtime import processor as j_proc
from odam_tpu.runtime import tracker as j_trk
from test_torch_bf16 import _numpy_tree, _unit_rows, _within_bar
from test_torch_pipeline import _pose
from torch_threads import one_torch_thread  # noqa: F401


def _pipelines(dtype_name):
    """A JAX and a port pipeline at ``dtype_name`` sharing seeded tiny
    weights (as tests/test_torch_pipeline.py builds them)."""
    dkw = dict(num_classes=8, num_queries=8, hidden_dim=32, nheads=4, enc_layers=1,
               dec_layers=1, dim_feedforward=32, aux_loss=False)
    akw = dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
               self_gnn_layers=("self",), sinkhorn_iterations=20)
    T, W, N = 8, 6, 5
    j32 = j_detr.DETR(j_detr.DETRConfig(**dkw))
    dparams = _numpy_tree(jax.jit(j32.init)(jax.random.key(1), jnp.zeros((1, 64, 64, 3))))
    # Seeded queries score alike (top two within 1e-3 of each other), so
    # bf16 rounding would pick another query as a frame's detection; a
    # class head 8x as steep separates them (top-two margin >= 0.017 on
    # these six frames), and no keep decision is a rounding tie.
    dparams["params"]["class_embed"]["kernel"] = dparams["params"]["class_embed"]["kernel"] * 8
    aparams = jax.jit(j_assoc.Associator(j_assoc.AssociatorConfig(**akw)).init)(
        jax.random.key(1), jnp.full((1, T, W, 79), -1.0), jnp.zeros((1, T), bool),
        jnp.full((1, N, 79), -1.0), jnp.zeros((1, N), bool))
    pkw = dict(detect_threshold=0.0, score_threshold=0.0, max_tracks=T, max_dets=N, window=W,
               track_bbox_samples=64, max_log_frames=16)
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    jpipe = j_proc.OdamPipeline(
        j_detr.DETR(j_detr.DETRConfig(**dkw, dtype=jdt)), jax.tree.map(jnp.asarray, dparams),
        j_assoc.Associator(j_assoc.AssociatorConfig(**akw, dtype=jdt)), aparams,
        j_proc.PipelineConfig(**pkw))
    tpipe = t_proc.OdamPipeline(
        t_detr.build_detr(t_detr.DETRConfig(**dkw, dtype=tdt), flax_params=_numpy_tree(dparams),
                          device="cpu"),
        t_assoc.build_associator(t_assoc.AssociatorConfig(**akw, dtype=tdt),
                                 flax_params=_numpy_tree(aparams), device="cpu"),
        t_proc.PipelineConfig(**pkw), device="cpu")
    return jpipe, tpipe


def test_bf16_whole_step_matches_over_six_frames():
    """The six-frame seeded step of tests/test_torch_pipeline.py in bf16,
    over YUV 4:2:0 frames (the card's transport): detections a frame, track
    ids and the log's ids equal to the port's float32 run; the tracks' mean
    states and the store's and the log's rows within the bar (JAX bf16 and JAX float32 as the references), rows with their
    pixel columns in units of the frame (``_unit_rows``).  XLA on the CPU
    keeps a fused chain of bf16 operations in float32 and rounds once at
    its end, where the port rounds after every operation, so in pixels the
    port's rows sit 2-3x further from float32 than JAX's (measured 0.55
    against 0.22 px of 64)."""
    K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    frames = [rgb_to_yuv420(rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8))
              for _ in range(6)]
    pipes = {}
    for name in ("float32", "bfloat16"):
        pipes[name] = _pipelines(name)
        for pipe in pipes[name]:
            pipe.init_sequence(K, 64, 64)
    n = {k: [] for k in ("t32", "t16")}
    for f, frame in enumerate(frames):
        for name, key in (("float32", "t32"), ("bfloat16", "t16")):
            jpipe, tpipe = pipes[name]
            jpipe.process_frame(frame, f, _pose(f))
            n[key].append(int(tpipe.process_frame(frame, f, _pose(f)).n_detections))
    assert n["t16"] == n["t32"]
    (j32, t32), (j16, t16) = pipes["float32"], pipes["bfloat16"]
    assert t16.model_dtype == torch.bfloat16
    s16, s32 = t16.sequence["store"], t32.sequence["store"]
    assert torch.equal(s16.track_id, s32.track_id) and torch.equal(s16.active, s32.active)
    assert torch.equal(t16.sequence["log"].ids, t32.sequence["log"].ids)
    for field, *means in zip(("mean t", "mean azimuth", "mean dims"), t_trk.mean_state(s16),
                             j_trk.mean_state(j16.sequence["store"]),
                             j_trk.mean_state(j32.sequence["store"])):
        _within_bar(field, *means)
    for name, rows in (("window", lambda s: s.sequence["store"].window),
                       ("log rows", lambda s: s.sequence["log"].rows)):
        _within_bar(name, *(_unit_rows(rows(p)) for p in (t16, j16, j32)))
    assert len(t16.tracks) == len(t32.tracks) > 0
