"""odam_torch's multi-rank layer on the CPU: 2 gloo ranks against one process
and against JAX's 2-device mesh.

One module-scoped job of ``odam_torch.scripts.dryrun_distributed`` runs
the six stages on 2 ranks (tiny models, dropout 0); the parent holds each
stage to the port in one process (``dryrun_distributed.compare``, whose
``TOL`` states each bar) and to JAX's mesh-sharded functions on
``jax.devices()[:2]`` (the bars of the single-device parity tests).  The
child ranks import only ``odam_torch``.  Small in-process cases cover the
mesh helpers against JAX's, ``init_distributed``'s failures, routing on
the global batch, the ranks' dropout masks and the global ``num_boxes``;
a 2-rank ``train_detector`` under ``torch.distributed.run`` writes the
one-process run's checkpoint.
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from odam_torch.models import associator as t_assoc
from odam_torch.models import convert
from odam_torch.models import criterion as t_crit
from odam_torch.models import detr as t_detr
from odam_torch.models import training as t_train
from odam_torch.ops import attention as t_attn
from odam_torch.ops import cuda_attention as t_ca
from odam_torch.parallel import distributed as t_dist
from odam_torch.parallel import mesh as t_mesh
from odam_torch.scripts import dryrun_distributed as dry
from odam_torch.utils import checkpoint
from odam_torch.utils.host_boxes import robust_box3d_iou
from odam_tpu.mapping import optimizer as j_opt
from odam_tpu.mapping import superquadric as j_sq
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import criterion as j_crit
from odam_tpu.models import detr as j_detr
from odam_tpu.models import training as j_train
from odam_tpu.parallel import mesh as j_mesh
from odam_tpu.runtime import offline as j_off
from odam_tpu.runtime import processor as j_proc
from odam_tpu.runtime import scene_parallel as j_sp

ROOT = dry.ROOT
HARD_CONFIG = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard", "rehearsal.yaml")
WORLD = 2
JOB_TIMEOUT_S = 240.0
# single-device parity bars of tests/test_torch_training.py and
# tests/test_torch_mapping.py, held here against JAX's 2-device mesh
JAX_RTOL = 1e-4
SOLVE_POSE_ATOL, SOLVE_SHAPE_ATOL, SOLVE_IOU, SOLVE_LOSS_RTOL = 0.05, 0.5, 0.85, 1e-3


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def _train_cli(out_dir, ranks):
    argv = ["-m", "odam_torch.scripts.train_detector", "--device", "cpu", "--synthetic",
            "--steps", "2", "--log_every", "1", "--config_path", HARD_CONFIG, "--img_h", "64",
            "--img_w", "64", "--batch_size", "2", "--dtype", "float32", "--out_dir", out_dir]
    if ranks > 1:
        argv = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(ranks),
                *argv]
    log = open(out_dir + ".log", "w")
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=_env(), stdout=log,
                            stderr=subprocess.STDOUT), log


def _wait(proc, log, what):
    try:
        proc.wait(timeout=JOB_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    with open(log.name) as f:
        text = f.read()
    assert proc.returncode == 0, f"{what}: rc {proc.returncode}\n{text[-4000:]}"
    return text


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The 2-rank dryrun and both train CLI runs, and the one-process stages
    in a thread of this process, started with the module's first test so
    that they run while JAX compiles (the JAX tests come first); ``job``
    collects them."""
    root = tmp_path_factory.mktemp("dist")
    ranks = dry.start(WORLD, "gloo", "cpu", "tiny", str(root / "dryrun"), threads=1)
    clis = {n: _train_cli(str(root / f"train{n}"), n) for n in (1, WORLD)}
    one = {}

    def reference():
        try:
            one["result"] = dry.run_stages("tiny", "cpu")
        except BaseException as e:             # re-raised by ``job``
            one["error"] = e

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    thread = threading.Thread(target=reference)
    thread.start()
    yield dict(root=root, ranks=ranks, clis=clis, thread=thread, one=one)
    thread.join()
    torch.set_num_threads(n)
    for p in ranks + [p for p, _ in clis.values()]:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def job(spawned):
    """The one-process stages and every rank's results."""
    root = spawned["root"]
    spawned["thread"].join(JOB_TIMEOUT_S)
    results = dry.wait(spawned["ranks"], str(root / "dryrun"), JOB_TIMEOUT_S)
    logs = {n: _wait(p, log, f"train_detector on {n} rank(s)")
            for n, (p, log) in spawned["clis"].items()}
    assert not spawned["thread"].is_alive(), "the one-process stages did not finish"
    if "error" in spawned["one"]:
        raise spawned["one"]["error"]
    return dict(reference=spawned["one"]["result"], ranks=results, root=root, logs=logs)


# ----------------------------------------------------- against JAX's mesh

@pytest.fixture(scope="module")
def jmesh():
    return j_mesh.make_mesh({"dp": WORLD}, jax.devices()[:WORLD])


def _flax(model):
    return {"params": jax.tree.map(jnp.asarray, convert.state_dict_to_flax(model))}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _hold_train(stage, arrays, jlosses, jgrads, jparams):
    """A rank's losses (``jlosses``: the rank's key -> JAX's value),
    first-step gradients and final parameters against JAX's: losses rtol
    1e-4; each leaf's gradient and parameters within 1e-4 of JAX's in
    relative norm (rounding-noise leaves: 2 x 3 x lr apart)."""
    got = dry._stage(arrays, stage)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=JAX_RTOL, err_msg=f"{stage} {k}")
    jg = {"/".join(p): np.asarray(g) for p, g in _paths(jgrads["params"])}
    norm = np.sqrt(sum(float(np.square(g).sum()) for g in jg.values()))
    noise = {k for k, g in jg.items() if np.linalg.norm(g) <= 1e-6 * norm}
    for k, g in jg.items():
        if f"grad/{k}" in got and k not in noise:
            err = np.linalg.norm(got[f"grad/{k}"] - g)
            assert err <= JAX_RTOL * np.linalg.norm(g), (stage, k, err)
    lr = 1e-4
    for p, v in _paths(jparams["params"]):
        k, v = "/".join(p), np.asarray(v)
        if k in noise:
            assert np.abs(got[f"param/{k}"] - v).max() <= 2 * dry.TRAIN_STEPS * lr, k
        else:
            assert np.linalg.norm(got[f"param/{k}"] - v) <= JAX_RTOL * np.linalg.norm(v), k


def _recording(tx):
    """``tx`` with the gradients of its last update kept in its state, so
    that JAX's own train step gives them without a second compile."""

    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _jax_steps(step_fn, state, mesh, args, n=dry.TRAIN_STEPS):
    """n steps from ``state`` replicated on ``mesh`` (so that the steps after
    the first find the compiled one): (each step's output, the first step's
    gradients, the final parameters), as numpy."""
    state = jax.device_put(state, NamedSharding(mesh, P()))
    losses, grads = [], None
    for i in range(n):
        state, out = step_fn(state, *args(i))
        losses.append(jax.tree.map(np.asarray, out))
        if i == 0:
            grads = jax.tree.map(np.asarray, state.opt_state[0])
    return losses, grads, jax.tree.map(np.asarray, state.params)


def test_detr_train_matches_jax_mesh(request, jmesh):
    """3 steps of JAX's make_detr_train_step on the 2-device mesh, from the
    port's seeded weights and the same global batch, against both ranks."""
    model = t_detr.build_detr(dry._train_detr_config("tiny"), seed=0, device="cpu")
    params = _flax(model)
    jm = j_detr.DETR(j_detr.DETRConfig(**dry.SIZES["tiny"]["train_detr"]))
    jcfg = j_train.DetrTrainConfig(criterion=j_crit.CriterionConfig(num_classes=4))
    tx = _recording(j_train.make_detr_optimizer(params, jcfg))
    step = j_train.make_detr_train_step(jm, tx, jcfg, jmesh)
    images, targets = dry.detr_batch("tiny")
    images = j_mesh.shard_batch(jnp.asarray(images), jmesh)
    targets = j_crit.Targets(*j_mesh.shard_batch(tuple(map(jnp.asarray, targets)), jmesh))
    losses, grads, final = _jax_steps(step, j_train.init_train_state(params, tx), jmesh,
                                      lambda i: (images, targets, jax.random.key(i)))
    losses = {f"loss/{i}/{k}": v for i, m in enumerate(losses) for k, v in m.items()}
    for arrays, _ in request.getfixturevalue("job")["ranks"]:
        _hold_train("detr_train", arrays, losses, grads, final)


def test_assoc_train_matches_jax_mesh(request, jmesh):
    model = t_assoc.build_associator(dry._assoc_config("tiny", use_kernels=False), seed=2,
                                     device="cpu")
    params = _flax(model)
    jm = j_assoc.Associator(j_assoc.AssociatorConfig(**dry.SIZES["tiny"]["assoc"]))
    tx = _recording(optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4)))
    step = j_train.make_assoc_train_step(jm, tx, jmesh)
    batch = [j_mesh.shard_batch(jnp.asarray(x), jmesh) for x in dry.assoc_batch("tiny")]
    losses, grads, final = _jax_steps(step, j_train.init_train_state(params, tx), jmesh,
                                      lambda i: batch)
    losses = {f"loss/{i}": v for i, v in enumerate(losses)}
    for arrays, _ in request.getfixturevalue("job")["ranks"]:
        _hold_train("assoc_train", arrays, losses, grads, final)


def test_detect_matches_jax_mesh(request, jmesh):
    """JAX's BatchedDetector(mesh=...) on the same 5 frames (batch 4, a
    ragged last stack): valid and classes exact, floats within 1e-4."""
    detr, _, _ = dry.lane_models("tiny", "cpu")
    S = dry.SIZES["tiny"]
    h, w = S["detect_image"]
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(S["detect_batch"] + 1)]
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]], np.float32)
    det = j_off.BatchedDetector(j_detr.DETR(j_detr.DETRConfig(**dry.TINY_DETR)), _flax(detr),
                                j_proc.PipelineConfig(detect_threshold=0.0),
                                batch_size=S["detect_batch"], mesh=jmesh)
    dets = det.detect_frames(frames, K, float(w), float(h))
    want = {name: np.concatenate([np.asarray(getattr(d, name)) for d in dets])
            for name in t_detr.Detections._fields}
    for arrays, _ in request.getfixturevalue("job")["ranks"]:
        got = dry._stage(arrays, "detect")
        for name, v in want.items():
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(got[name], v, err_msg=name)
            else:
                np.testing.assert_allclose(got[name], v, atol=JAX_RTOL, rtol=JAX_RTOL,
                                           err_msg=name)


def test_lanes_match_jax_mesh(request, jmesh, monkeypatch):
    """JAX's SceneParallelRunner with 4 lanes on the 2-device mesh against
    both ranks' outputs: tracks with frame ids, classes and order exact,
    rows within 1e-4, bboxes_dl within 1e-3, bboxes_qc at IoU >= 0.95 (the
    bars of tests/test_torch_scene_parallel.py's runner test).  The runner's
    initial stores are placed on the lane sharding, as its later steps get
    them, so that its step compiles once."""
    stack = j_sp._stack
    monkeypatch.setattr(j_sp, "_stack", lambda trees: jax.device_put(
        stack(trees), NamedSharding(jmesh, P("dp"))))
    detr, assoc, _ = dry.lane_models("tiny", "cpu")
    S = dry.SIZES["tiny"]
    runner = j_sp.SceneParallelRunner(
        j_detr.DETR(j_detr.DETRConfig(**dry.TINY_DETR)), _flax(detr),
        j_assoc.Associator(j_assoc.AssociatorConfig(**dry.TINY_ASSOC)), _flax(assoc),
        j_proc.PipelineConfig(**dry.TINY_PIPE), jmesh, n_lanes=S["n_lanes"])
    want = runner.run_scenes(dry.lane_scenes(S["lane_lengths"], S["lane_image"]),
                             *map(float, S["lane_image"]))
    for arrays, _ in request.getfixturevalue("job")["ranks"]:
        got = dry._stage(arrays, "lanes")
        for j, w in enumerate(want):
            w = jax.tree.map(np.asarray, w)
            n = int(got[f"{j}/tracks/len"])
            assert n == len(w["tracks"]) >= 1, j
            for k in range(n):
                g = got[f"{j}/tracks/{k}"]
                np.testing.assert_array_equal(g[:, :2], w["tracks"][k][:, :2])
                np.testing.assert_allclose(g, w["tracks"][k], atol=1e-4)
                np.testing.assert_allclose(got[f"{j}/bboxes_dl/{k}"], w["bboxes_dl"][k],
                                           atol=1e-3)
                assert robust_box3d_iou(got[f"{j}/bboxes_qc/{k}"], w["bboxes_qc"][k]) >= 0.95


def test_solve_matches_jax_mesh(request):
    """JAX's solve with its object axis over a 2-device ``mp`` mesh, padded
    as the port pads (the last object repeated and frozen), against both
    ranks: the bars of tests/test_torch_mapping.py's whole-solve test (pose
    atol 0.05, shape logits 0.5, corner IoU >= 0.85, the loss log rtol 1e-3
    over the first iterations, frozen boxes within 1e-6)."""
    inputs, S = dry.solve_inputs("tiny", "cpu")
    init, rest = inputs[0], inputs[1:]
    O = rest[0].shape[0]
    take = t_mesh.pad_to_multiple(np.arange(O), WORLD, fill=O - 1)
    mp = j_mesh.make_mesh({"mp": WORLD}, jax.devices()[:WORLD])
    sh = NamedSharding(mp, P("mp"))
    args = [jax.device_put(jnp.asarray(x.numpy()[take]), sh) for x in rest]
    args[-1] = jax.device_put(jnp.asarray(rest[-1].numpy()[take] & (np.arange(len(take)) < O)),
                              sh)
    jinit = j_sq.SQParams(*[jax.device_put(jnp.asarray(t.numpy()[take]), sh) for t in init])
    res = j_opt.optimize_superquadrics(jinit, *args, None, n_iters=S["iters"],
                                       n_samples=S["samples"], use_prior=False)
    for arrays, _ in request.getfixturevalue("job")["ranks"]:
        got = dry._stage(arrays, "solve")
        for name in ("translate", "angle", "scales"):
            np.testing.assert_allclose(got[f"params/{name}"], np.asarray(getattr(res.params,
                                       name))[:O], atol=SOLVE_POSE_ATOL, err_msg=name)
        np.testing.assert_allclose(got["params/shapes"], np.asarray(res.params.shapes)[:O],
                                   atol=SOLVE_SHAPE_ATOL)
        np.testing.assert_allclose(got["loss_log"], np.asarray(res.loss_log),
                                   rtol=SOLVE_LOSS_RTOL)
        corners = np.asarray(res.corners)[:O]
        for o in range(O - 1):
            assert robust_box3d_iou(got["corners"][o], corners[o]) >= SOLVE_IOU, o
        np.testing.assert_allclose(got["corners"][O - 1], corners[O - 1], atol=1e-6)


# ------------------------------------------------- ranks against one process

@pytest.mark.parametrize("stage", dry.STAGES)
def test_ranks_equal_one_process(job, stage):
    """Each stage of both ranks against the one-process port, by
    dryrun_distributed.TOL: losses rtol 1e-6, gradients after the reduce
    within 1e-5 of the largest, parameters after 3 steps within 1e-5
    (rounding-noise leaves within 2 x 3 x lr), matches exact; detections
    exact in ints, 1e-5 in floats, routed as one process routes; the mp solve
    rtol 1e-4; the collectives' closed forms exactly; lanes with ids and
    classes exact, rows at atol = rtol = 1e-3."""
    ranks = [({k: v for k, v in a.items() if k.startswith(stage + "/")}, r)
             for a, r in job["ranks"]]
    report = dry.compare(job["reference"], ranks)
    assert report["stages"] == [stage]
    for r in range(WORLD):
        assert report[f"rank{r}"] or stage == "collectives"


def test_ranks_ran_their_own_lanes_and_one_shard(job):
    """Rank 0 ran lanes 0-1 (scenes 0 and 1), rank 1 lanes 2-3 (scene 2 and
    padding), each at B / lanes = 1 on the fused kernel's wrapper; the
    sharded detector took the plain path on both (global batch 4); every
    rank's train steps timed their all-reduce."""
    for r, (_, report) in enumerate(job["ranks"]):
        assert report["lanes"]["lanes_this_rank"] == 2, r
        assert report["lanes"]["plain_calls"]["fused_attention"] > 0, r
        assert report["detect"]["plain_calls"] == {"fused_attention": 0, "flash_attention": 0}
        assert len(report["detr_train"]["allreduce_ms"]) == 5
    assert job["reference"][1]["lanes"]["lanes_this_rank"] == 4


# --------------------------------------------------------------- in-process

def test_mesh_helpers_match_jax():
    """pad_to_multiple and shard_batch against JAX's (each of 2 ranks'
    blocks against the device shards), and both divisibility errors."""
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    np.testing.assert_array_equal(t_mesh.pad_to_multiple(x, 4, fill=-1.0),
                                  j_mesh.pad_to_multiple(x, 4, fill=-1.0))
    np.testing.assert_array_equal(t_mesh.pad_to_multiple(x, 5, axis=0), x)
    np.testing.assert_array_equal(t_mesh.pad_to_multiple(x, 2, axis=1),
                                  j_mesh.pad_to_multiple(x, 2, axis=1))
    x = x[:4]
    jm = j_mesh.make_mesh({"dp": WORLD}, jax.devices()[:WORLD])
    shards = j_mesh.shard_batch(jnp.asarray(x), jm).addressable_shards
    blocks = {s.index[0].start or 0: np.asarray(s.data) for s in shards}
    for r in range(WORLD):
        mesh = t_mesh.Mesh(("dp",), (WORLD,), r, torch.device("cpu"))
        got = t_mesh.shard_batch({"a": x, "b": (torch.from_numpy(x),)}, mesh)
        np.testing.assert_array_equal(got["a"], blocks[2 * r])
        assert torch.equal(got["b"][0], torch.from_numpy(blocks[2 * r]))
    with pytest.raises(ValueError, match="does not divide"):
        t_mesh.shard_batch(x[:3], t_mesh.Mesh(("dp",), (WORLD,), 0, torch.device("cpu")))
    with pytest.raises(Exception):
        j_mesh.shard_batch(jnp.asarray(x[:3]), jm)
    with pytest.raises(ValueError):
        t_mesh.make_mesh({"dp": 2}, device="cpu")            # one process has one rank
    one = t_mesh.make_mesh(device="cpu")
    assert one.shape == {"dp": 1} and one.group is None and one.index("dp") == 0
    x = torch.arange(4.0)
    assert t_mesh.gather_batch(x, one) is x


def test_init_distributed_raises_on_an_unreachable_group(monkeypatch):
    """The explicit form, as rank 1 of 2 with nobody at the address, raises
    within its short timeout; the no-argument form without a launcher's
    variables is a no-op."""
    for var in t_dist.LAUNCHER_VARS + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    assert t_dist.init_distributed(device="cpu") == torch.device("cpu")
    assert t_dist.process_count() == 1 and t_dist.process_index() == 0
    assert not torch.distributed.is_initialized()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        t_dist.init_distributed(f"tcp://localhost:{dry.free_port()}", 2, 1, "gloo", "cpu",
                                timeout_s=0.5)
    assert time.perf_counter() - t0 < 30
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="nccl"):
        t_dist.init_distributed("tcp://localhost:1", 2, 0, "nccl", "cpu")


def test_launcher_env_form_raises_instead_of_running_alone(monkeypatch):
    """With a launcher's variables and no peer, the no-argument form raises
    (JAX's would carry on in one process)."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(dry.free_port()))
    with pytest.raises(RuntimeError):
        t_dist.init_distributed(device="cpu", timeout_s=0.5)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("B,shards,kernel", [(2, 2, False), (1, 2, True), (2, 1, True),
                                             (1, 4, False)])
def test_mha_core_routes_a_shard_on_the_global_batch(B, shards, kernel):
    """A rank's block of B rows of a batch over ``shards`` ranks routes as
    the global B x shards does in JAX: global 4 over 2 shards takes the
    plain path, counted by cuda_attention.PLAIN_CALLS."""
    rng = np.random.default_rng(B + 10 * shards)
    q, k = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((B, 5, 32), (B, 40, 32)))
    t_ca.reset_counts()
    out = t_attn.mha_core(q, k, k, 4, shards=shards)
    assert t_ca.PLAIN_CALLS["fused_attention"] == int(kernel)
    ref = t_attn.mha_core(q, k, k, 4, use_kernels=False)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def test_dropout_masks_differ_between_ranks():
    """The train step seeds dropout with step x world + rank: at world 1 the
    step (JAX's key), across 2 ranks distinct seeds, and the masks differ."""
    state = t_train.TrainState(None, None, step=3)
    assert t_train._seed(state, None) == 3
    meshes = [t_mesh.Mesh(("dp",), (WORLD,), r, torch.device("cpu")) for r in range(WORLD)]
    seeds = {t_train._seed(t_train.TrainState(None, None, s), m) for s in range(3) for m in meshes}
    assert len(seeds) == 3 * WORLD
    model = t_detr.build_detr(t_detr.DETRConfig(**dry.SIZES["tiny"]["train_detr"] | {
        "dropout": 0.5}), seed=3, device="cpu").train()
    img = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = (model(img, generator=torch.Generator().manual_seed(t_train._seed(state, m)))
                ["pred_logits"] for m in meshes)
    assert not torch.equal(a, b)


def test_global_num_boxes_with_a_rank_that_holds_none(job):
    """The tiny batch puts 5 boxes on rank 0 and none on rank 1.  A per-rank
    normalizer (a DDP mean of the ranks' own losses) gives a gradient far
    from the one-process gradient; the ranks' global normalizers give it
    within 1e-5 of the largest (test_ranks_equal_one_process)."""
    model = t_detr.build_detr(dry._train_detr_config("tiny"), seed=0, device="cpu").train()
    images, targets = dry.detr_batch("tiny")
    assert targets[-1][:2].sum() == 5 and targets[-1][2:].sum() == 0
    cfg = t_crit.CriterionConfig(num_classes=4)
    losses = []
    for r in range(WORLD):
        im, tg = t_mesh.shard_batch((images, targets),
                                    t_mesh.Mesh(("dp",), (WORLD,), r, torch.device("cpu")))
        out = model(torch.from_numpy(im))
        losses.append(t_crit.set_criterion(out, t_crit.Targets(*map(torch.from_numpy, tg)),
                                           cfg)[0])
    (sum(losses) / WORLD).backward()
    ref = dry._stage(job["reference"][0], "detr_train")
    got = dry._stage(job["ranks"][0][0], "detr_train")
    ddp_grads = dry.flatten(convert.tensors_to_flax(model, {
        k: p.grad for k, p in model.named_parameters() if p.grad is not None}))
    largest = max(np.abs(v).max() for k, v in ref.items() if k.startswith("grad/"))
    ddp = max(np.abs(g - ref["grad/" + k]).max() for k, g in ddp_grads.items()
              if "grad/" + k in ref)
    dist = max(np.abs(got[k] - v).max() for k, v in ref.items() if k.startswith("grad/"))
    assert ddp > 1e-2 * largest and dist <= 1e-5 * largest, (ddp, dist, largest)


def test_train_detector_on_two_ranks_writes_the_one_process_checkpoint(job):
    """``torch.distributed.run --nproc_per_node 2 -m train_detector`` (gloo on
    the CPU, 64x64, batch 2, 2 steps, the rehearsal config: dropout 0)
    against the one-process run: the same ckpt_2 (parameters and Adam moments
    within 1e-5, the step count equal), one log written by rank 0 with the
    global loss within 1e-6 relative."""
    root = job["root"]
    one, two = (str(root / f"train{n}" / "ckpt_2") for n in (1, WORLD))
    p1, o1, m1 = checkpoint.restore(one)
    p2, o2, m2 = checkpoint.restore(two)
    assert m1["step"] == m2["step"] == 2
    for (path, a), (_, b) in zip(_paths(p1), _paths(p2)):
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg="/".join(path))
    assert set(o1) == set(o2)
    for k in o1:
        np.testing.assert_allclose(o2[k], o1[k], atol=1e-5, err_msg=k)
    rows = []
    for n in (1, WORLD):
        with open(str(root / f"train{n}" / "train_log.jsonl")) as f:
            rows.append([json.loads(line) for line in f])
    assert [r["step"] for r in rows[1]] == [1, 2]
    for a, b in zip(*rows):
        np.testing.assert_allclose(b["total"], a["total"], rtol=1e-6)
