"""The mapping solve's CUDA graph on the card, against the same iterations
run eagerly: ``optimize_superquadrics`` on a CUDA device captures one Adam
iteration (``StaticSolve.iteration``) and replays it, and must give what a
plain loop of ``solve_step`` with int counts gives, bit for bit, at the
benchmark's shapes (64 objects x 256 views, 1000 samples, 200 iterations)
on a seeded synthetic scene.  Also: the graphs' cache, its bound and its
counters, and results that do not share memory.  Skips without a CUDA
device.  On a machine with a card and without JAX (which
``tests/conftest.py`` imports)::

    python3 -m pytest tests/test_torch_optim_graph.py --noconftest -p no:cacheprovider
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from odam_torch.mapping import optimizer, prior
from odam_torch.mapping import superquadric as sq
from torch_threads import one_torch_thread  # noqa: F401

O, V, S, ITERS = 64, 256, 1000, 200
IMG_H, IMG_W, FOCAL = 800, 1071, 900.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    optimizer._GRAPHS.clear()
    return torch.device("cuda", 0)


def _look_at(cam: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera [3, 4] of a camera at ``cam`` looking at ``target``
    (x right, y down, z forward)."""
    z = target - cam
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return np.c_[R, -R @ cam]


def scene(seed: int, n_objs: int = O, n_views: int = V):
    """``n_objs`` boxes, each seen from a ring of ``n_views`` cameras, as the
    solve's inputs: boxes from the projected corners plus 1.5 px noise, 85%
    of the edges active, some view slots empty and two objects frozen, and
    inits at detector-level noise."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-3.0, 3.0, (n_objs, 3))
    dims = rng.uniform(0.4, 1.4, (n_objs, 3))
    ctr[:, 2] = dims[:, 2] / 2
    yaw = rng.uniform(-1.5, 1.5, n_objs)
    K = np.array([[FOCAL, 0, IMG_W / 2], [0, FOCAL, IMG_H / 2], [0, 0, 1]])
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    P_cw = np.zeros((n_objs, n_views, 3, 4))
    boxes = np.zeros((n_objs, n_views, 4))
    for o in range(n_objs):
        c, s = np.cos(yaw[o]), np.sin(yaw[o])
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        corners = (signs * dims[o] / 2) @ R.T + ctr[o]
        for v in range(n_views):
            phi = 2 * np.pi * v / n_views + 0.1 * o
            cam = ctr[o] + [3.0 * np.cos(phi), 3.0 * np.sin(phi), 1.0]
            P_cw[o, v] = K @ _look_at(cam, ctr[o])
            pix = np.c_[corners, np.ones(8)] @ P_cw[o, v].T
            uv = pix[:, :2] / np.abs(pix[:, 2:])
            boxes[o, v] = [uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()]
    boxes += rng.normal(0, 1.5, boxes.shape)
    box_mask = rng.random((n_objs, n_views, 4)) < 0.85
    view_mask = np.ones((n_objs, n_views), bool)
    view_mask[: n_objs // 4, n_views // 2:] = False
    om = np.ones(n_objs, bool)
    om[[1, n_objs // 2]] = False
    init = (ctr + rng.normal(0, 0.08, ctr.shape), yaw + rng.normal(0, 0.05, n_objs),
            dims * rng.uniform(0.85, 1.15, dims.shape))
    invcov = prior.prior_invcov_for_classes(np.arange(n_objs) % 8)
    return init, (boxes, box_mask, view_mask, P_cw, om, invcov)


def _on(arrays, dev):
    out = []
    for a in arrays:
        a = np.asarray(a)
        out.append(torch.from_numpy(a).to(dev) if a.dtype == bool
                   else torch.from_numpy(a.astype(np.float32)).to(dev))
    return out


def _solve(init, inputs, rep, dev, n_iters=ITERS):
    boxes, box_mask, view_mask, P_cw, om, invcov = _on(inputs, dev)
    p0 = sq.init_params(*_on(init, dev), rep)
    return optimizer.optimize_superquadrics(
        p0, boxes, box_mask.float(), view_mask.float(), P_cw, om, invcov, n_iters=n_iters,
        n_samples=S, representation=rep)


def _eager(init, inputs, rep, dev):
    """``solve_step`` in a plain loop with int counts: the losses and the
    final params."""
    boxes, box_mask, view_mask, P_cw, om, invcov = _on(inputs, dev)
    params = sq.init_params(*_on(init, dev), rep)
    args = (boxes, box_mask.float(), view_mask.float(), P_cw, om.float(), params.scales, invcov)
    state, losses = optimizer.init_adam(params, rep), []
    for _ in range(ITERS):
        params, state, loss = optimizer.solve_step(params, state, *args, S, rep)
        losses.append(loss)
    return torch.stack(losses), params


@pytest.mark.h100
@pytest.mark.parametrize("rep", ["super_quadric", "cube"])
def test_the_graph_matches_the_eager_loop_bit_for_bit(card, rep):
    init, inputs = scene(1)
    captures = optimizer.COUNTS["graph_captures"]
    replays = optimizer.COUNTS["graph_iterations"]
    res = _solve(init, inputs, rep, card)
    assert optimizer.COUNTS["graph_captures"] == captures + 1
    assert optimizer.COUNTS["graph_iterations"] == replays + ITERS - optimizer.GRAPH_WARMUP
    losses, params = _eager(init, inputs, rep, card)
    assert res.loss_log.shape == (ITERS,) and bool(torch.isfinite(res.loss_log).all())
    gap = (res.loss_log - losses).abs().max().item()
    assert torch.equal(res.loss_log, losses), f"loss log differs by up to {gap}"
    for name, a, b in zip(sq.SQParams._fields, res.params, params):
        assert torch.equal(a, b), (name, (a - b).abs().max().item())
    print(f"\n{rep}: loss {losses[0].item():.2f} -> {losses[-1].item():.2f}, bit-equal")


@pytest.mark.h100
def test_a_second_call_replays_without_a_capture_or_a_wait(card):
    init, inputs = scene(2)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(card)
    _solve(init, inputs, "super_quadric", card)
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()          # what stays is the graph's pool and the static tensors
    captured = torch.cuda.memory_reserved(card) - reserved
    captures = optimizer.COUNTS["graph_captures"]
    replays = optimizer.COUNTS["graph_iterations"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _solve(init, inputs, "super_quadric", card)
    end.record()
    queued = not end.query()        # the call returned with the solve still queued
    end.synchronize()
    assert queued
    assert optimizer.COUNTS["graph_captures"] == captures
    assert optimizer.COUNTS["graph_iterations"] == replays + ITERS
    assert len(optimizer._GRAPHS) == 1
    print(f"\nfirst call reserved {captured / 2**30:.2f} GiB; a cached 200-iteration solve "
          f"{start.elapsed_time(end):.1f} ms on {torch.cuda.get_device_name(card)}")


@pytest.mark.h100
def test_a_new_shape_captures_again_and_the_cache_keeps_its_bound(card):
    n_iters = optimizer.GRAPH_WARMUP + 2
    shapes = [O - k for k in range(optimizer.GRAPH_CACHE + 1)]
    for k, n in enumerate(shapes):
        captures = optimizer.COUNTS["graph_captures"]
        init, inputs = scene(3, n_objs=n, n_views=32)
        _solve(init, inputs, "super_quadric", card, n_iters)
        assert optimizer.COUNTS["graph_captures"] == captures + 1, n
        assert len(optimizer._GRAPHS) == min(k + 1, optimizer.GRAPH_CACHE)
    # the first shape was dropped, the latest kept
    for n, captured in ((shapes[-1], 0), (shapes[0], 1)):
        captures = optimizer.COUNTS["graph_captures"]
        init, inputs = scene(3, n_objs=n, n_views=32)
        _solve(init, inputs, "super_quadric", card, n_iters)
        assert optimizer.COUNTS["graph_captures"] == captures + captured, n
    assert len(optimizer._GRAPHS) == optimizer.GRAPH_CACHE


@pytest.mark.h100
def test_two_results_held_at_once_do_not_share_memory(card):
    a = _solve(*scene(4), "super_quadric", card)
    kept = [t.clone() for t in (*a.params, a.loss_log, a.corners)]
    b = _solve(*scene(5), "super_quadric", card)
    assert len(optimizer._GRAPHS) == 1
    for x, y in zip((*a.params, a.loss_log, a.corners), kept):
        assert torch.equal(x, y)
    assert not torch.equal(a.loss_log, b.loss_log)
    (static,) = optimizer._GRAPHS.values()
    held = [t.data_ptr() for res in (a, b) for t in (*res.params, res.loss_log)]
    inner = [t.data_ptr() for t in (*static.params, static.loss, *static.inputs)]
    assert len(set(held)) == len(held) and not set(held) & set(inner)


@pytest.mark.h100
def test_a_capture_holds_beside_another_threads_allocation(card, monkeypatch):
    """While a solve's graph is being captured, another thread of the process
    allocates fresh device memory (a cudaMalloc, which in the default capture
    mode breaks a capture made in any thread), as ``chip_smoke.py``'s
    studies run the recall diagnosis's stages in threads side by side: the
    capture holds, and the losses equal the eager loop's."""
    import threading

    real, fresh = optimizer.solve_step, {}

    def allocate():
        fresh["t"] = torch.empty(3 << 28, dtype=torch.uint8, device=card)   # a new segment

    def solve_step(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing() and not fresh:
            worker = threading.Thread(target=allocate)
            worker.start()
            worker.join()
        return real(*args, **kwargs)

    torch.cuda.empty_cache()
    monkeypatch.setattr(optimizer, "solve_step", solve_step)
    init, inputs = scene(5, n_objs=16, n_views=64)
    captures = optimizer.COUNTS["graph_captures"]
    res = _solve(init, inputs, "super_quadric", card)
    monkeypatch.setattr(optimizer, "solve_step", real)
    assert "t" in fresh and optimizer.COUNTS["graph_captures"] == captures + 1
    losses, _ = _eager(init, inputs, "super_quadric", card)
    assert torch.equal(res.loss_log, losses)
