"""odam_torch's bf16 models against odam_tpu's on the CPU.

JAX's plain attention on the CPU runs its softmax in bf16, the port's plain
version computes in float32 and casts (``cuda_attention.attention_plain``),
so the port's bf16 is not held to JAX's bf16 element by element.  The bar,
on every float output: the port's bf16 error against JAX's float32 is at
most twice JAX bf16's error against JAX float32, plus an absolute floor of
2^-8 (one bf16 rounding of an O(1) value).  Integer outputs (classes, keep
masks, matches, track ids) must equal the port's own float32 outputs on the
seeded cases; a failure prints the margin of the flipped decision.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.models import associator as t_assoc
from odam_torch.models import detr as t_detr
from odam_torch.ops import kernels
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import detr as j_detr
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FLOOR = 2.0 ** -8
HEADS = ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size", "pred_depth",
         "pred_obj_features")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _within_bar(name, port16, jax16, jax32):
    port_err = float(np.abs(_f32(port16) - _f32(jax32)).max())
    jax_err = float(np.abs(_f32(jax16) - _f32(jax32)).max())
    assert port_err <= 2 * jax_err + FLOOR, (name, port_err, jax_err)
    return port_err, jax_err


def _unit_rows(rows, size=64.0):
    """82-column track rows with the pixel columns (2:6, 78:82) divided by
    the frame's size: the heads' own O(1) units, where the 2^-8 floor
    applies (a box edge is a sigmoid output times the frame's width)."""
    rows = _f32(rows).copy()
    rows[..., 2:6] /= size
    rows[..., 78:82] /= size
    return rows


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("backbone", ["resnet50", "tiny"])
def test_bf16_detr_matches(backbone):
    """The DETR forward in bf16: full-width ResNet-50 (hidden 256, 8 heads,
    100 queries, 1+1 layers) at 64x64, and TinyBackbone with a padding mask;
    every head and aux head within the bar, outputs in bf16, the attention
    calls made in bf16 (B = 1 takes the kernels' plain versions here), and
    postprocess's keep mask and classes equal to the port's float32 ones."""
    if backbone == "tiny":
        kw = dict(num_classes=8, num_queries=12, hidden_dim=32, nheads=4, enc_layers=2,
                  dec_layers=2, dim_feedforward=64, backbone="tiny", backbone_stage=3)
        shape = (1, 96, 80)
    else:
        kw, shape = dict(enc_layers=1, dec_layers=1), (1, 64, 64)
    rng = np.random.default_rng(1)
    img = rng.normal(size=shape + (3,)).astype(np.float32)
    mask = np.zeros(shape, bool)
    mask[0, int(shape[1] * 0.7):] = backbone == "tiny"
    j32m = j_detr.DETR(j_detr.DETRConfig(**kw))
    params = jax.jit(j32m.init)(jax.random.key(1), jnp.asarray(img), jnp.asarray(mask))
    j32 = jax.jit(j32m.apply)(params, jnp.asarray(img), jnp.asarray(mask))
    j16 = jax.jit(j_detr.DETR(j_detr.DETRConfig(**kw, dtype=jnp.bfloat16)).apply)(
        params, jnp.asarray(img), jnp.asarray(mask))
    models = {dt: t_detr.build_detr(t_detr.DETRConfig(**kw, dtype=dt),
                                    flax_params=_numpy_tree(params), device="cpu")
              for dt in (torch.float32, torch.bfloat16)}
    kernels.zero_counts()
    with torch.no_grad():
        t16 = models[torch.bfloat16](torch.from_numpy(img), torch.from_numpy(mask))
        t32 = models[torch.float32](torch.from_numpy(img), torch.from_numpy(mask))
    assert kernels.counts("PLAIN_CALLS_BY_DTYPE")["fused_attention"]["bfloat16"] > 0
    assert t16["pred_logits"].dtype == torch.bfloat16
    for name in HEADS:
        _within_bar(name, t16[name], j16[name], j32[name])
    for i, (a16, aj16, aj32) in enumerate(zip(t16["aux_outputs"], j16["aux_outputs"],
                                               j32["aux_outputs"])):
        for name in HEADS[:-1]:
            _within_bar(f"aux {i} {name}", a16[name], aj16[name], aj32[name])

    K = torch.tensor([[60.0, 0, 32], [0, 60, 32], [0, 0, 1]])
    d16 = t_detr.postprocess(t16, 64.0, 64.0, 0.05, K)
    d32 = t_detr.postprocess(t32, 64.0, 64.0, 0.05, K)
    probs = torch.softmax(t32["pred_logits"].float(), -1)[0, :, :-1]
    top2 = probs.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    assert torch.equal(d16.valid, d32.valid), f"keep mask flipped; class margin {margin:.2e}"
    v = d32.valid
    assert torch.equal(d16.classes[v], d32.classes[v]), f"class flipped; margin {margin:.2e}"
    assert int(v.sum()) > 0


REHEARSAL = dict(descriptor_dim=64, keypoint_encoder=(78, 64, 64),
                 gnn_layers=("self", "cross", "self", "cross"), self_gnn_layers=("self",),
                 sinkhorn_iterations=30)


@pytest.mark.parametrize("weights", ["full_width_seeded", "rehearsal_trained"])
def test_bf16_associator_matches(weights):
    """The associator in bf16 on 8 track slots (6 live) x 6 steps and 5
    detections (4 live, each near a track's last row): the pre-Sinkhorn
    scores and the finite entries of the log assignment within the bar.
    ``full_width_seeded`` is the default config (256-d, 2 fuser + 8 GNN
    layers) with seeded weights, whose assignment is near uniform (no
    probability above 0.43; JAX's own bf16 reorders its matches there), so
    its matches are not compared.  ``rehearsal_trained`` is the committed
    trained associator (artifacts/torch/rehearsal_hard_assoc.npz): its
    matches at threshold 0.01 equal the port's float32 ones."""
    from odam_torch.models import convert

    rng = np.random.default_rng(2)
    T, W, N = 8, 6, 5
    tracks = (rng.normal(size=(1, T, W, 79)) * 0.5).astype(np.float32)
    tracks[..., 0] = np.arange(W)
    dets = np.full((1, N, 79), -1.0, np.float32)
    dets[0, :, 1:] = tracks[0, :N, -1, 1:] + rng.normal(size=(N, 78)).astype(np.float32) * 0.05
    dets[0, :, 0] = W
    tm = np.arange(T)[None] < 6
    dm = np.arange(N)[None] < 4
    args = (tracks, tm, dets, dm)
    kw = {} if weights == "full_width_seeded" else REHEARSAL
    j32m = j_assoc.Associator(j_assoc.AssociatorConfig(**kw))
    if weights == "full_width_seeded":
        params = jax.jit(j32m.init)(jax.random.key(3), *map(jnp.asarray, args))
    else:
        params = convert.load_flax_npz(os.path.join(ROOT, "artifacts", "torch",
                                                    "rehearsal_hard_assoc.npz"))
    j32 = jax.jit(j32m.apply)(params, *map(jnp.asarray, args), 0.01)
    j16 = jax.jit(j_assoc.Associator(j_assoc.AssociatorConfig(**kw, dtype=jnp.bfloat16)).apply)(
        params, *map(jnp.asarray, args), 0.01)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        model = t_assoc.build_associator(t_assoc.AssociatorConfig(**kw, dtype=dt),
                                         flax_params=_numpy_tree(params), device="cpu")
        with torch.no_grad():
            out[dt] = model(*map(torch.from_numpy, args), 0.01)
    t16, t32 = out[torch.bfloat16], out[torch.float32]
    assert t16.scores.dtype == torch.float32 and t16.log_assignment.dtype == torch.float32
    _within_bar("scores", t16.scores[0, :6, :4], j16.scores[0, :6, :4], j32.scores[0, :6, :4])
    live = np.asarray(j32.log_assignment) > -1e8
    _within_bar("log_assignment", t16.log_assignment.numpy()[live],
                np.asarray(j16.log_assignment)[live], np.asarray(j32.log_assignment)[live])
    if weights == "rehearsal_trained":
        P = torch.exp(t32.log_assignment[0, :-1, :-1])
        assert int((t32.matches >= 0).sum()) >= 2
        assert torch.equal(t16.matches, t32.matches), (
            f"matches flipped; probabilities {P.max(0).values.tolist()}")


def test_bf16_layer_casts_are_cached_until_params_change():
    """A bf16 Dense and Conv outside autograd cast their float32 weight and
    bias once: a second call reuses the copies, a state-dict load (an
    in-place copy) makes new ones, and every output equals the cast at use
    that the layers take under autograd, exactly."""
    from odam_torch.models import layers

    torch.manual_seed(0)
    cases = ((layers.Dense(8, 4, dtype=torch.bfloat16), torch.randn(3, 8)),
             (layers.Conv(3, 4, 3, padding=1, dtype=torch.bfloat16), torch.randn(1, 3, 5, 5)))
    for layer, x in cases:
        with torch.no_grad():
            y1 = layer(x)
            cached = layer._cast_params
            assert torch.equal(layer(x), y1) and layer._cast_params is cached
            layer.load_state_dict({k: v * 2 for k, v in layer.state_dict().items()})
            y2 = layer(x)
            assert layer._cast_params is not cached
            assert torch.equal(layer._cast_params[0], layer.weight.to(torch.bfloat16))
        y_at_use = layer(x)
        assert y_at_use.dtype == torch.bfloat16 and y_at_use.requires_grad
        assert torch.equal(y2, y_at_use.detach())
        assert not torch.equal(y1, y2)
