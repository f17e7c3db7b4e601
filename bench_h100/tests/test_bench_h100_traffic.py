"""The traffic and the weights repeat exactly for a seed and differ across
seeds."""
from __future__ import annotations

import numpy as np
import torch

from bench_h100 import generators, weights


def _scene(seed):
    rng = np.random.default_rng(seed)
    tracks, fids, T_wcs, K, gt = generators.synthetic_scene(rng, 6, 24, 96, 128)
    return generators.fragment(rng, tracks, 2), T_wcs


def test_scenes_repeat_for_a_seed_and_differ_across_seeds():
    a, Ta = _scene(2 ** 31 + 5)
    b, _ = _scene(2 ** 31 + 5)
    c, _ = _scene(2 ** 31 + 6)
    assert len(a) == len(b) == 6 + 2 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, c))
    assert len(Ta) == 24


def test_fragments_split_a_track_in_two():
    rng = np.random.default_rng(3)
    tracks = [np.arange(40, dtype=np.float32).reshape(10, 4) + 100 * i for i in range(3)]
    out = generators.fragment(rng, tracks, 2)
    assert len(out) == 5
    rows = np.concatenate(out)
    assert len(rows) == 30 and np.array_equal(np.sort(rows[:, 0]), np.sort(
        np.concatenate(tracks)[:, 0]))


def test_stores_and_frames_repeat_and_differ():
    def store(seed):
        return generators.filled_window(np.random.default_rng(seed), 8, 10, 96, 128, 5, 6)

    a, b, c = store(9), store(9), store(10)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["window"], c["window"])
    assert int(a["count"]) == 5 and a["active"].sum() == 5 and (a["length"][:5] == 6).all()

    def pool(seed):
        g = torch.Generator().manual_seed(seed)
        return generators.frame_pool(g, 2, 3, 8, 12, torch.device("cpu"))

    assert torch.equal(pool(4), pool(4)) and not torch.equal(pool(4), pool(5))
    assert pool(4).shape == (2, 3, 8, 12, 3) and pool(4).dtype == torch.uint8
    P = generators.lane_pose(3.0, 1, 0.5)
    assert np.allclose(P[:3, :3] @ P[:3, :3].T, np.eye(3), atol=1e-6)


def test_weights_repeat_and_follow_fan_in():
    shapes = {"a.weight": (64, 128), "a.bias": (64,), "n.weight": (64,),
              "query_embed": (10, 64), "bin_score": (), "c.weight": (32, 16, 3, 3),
              "bn.running_var": (32,), "bn.running_mean": (32,)}

    def draw(seed):
        return weights.seeded_state(shapes, torch.Generator().manual_seed(seed),
                                    torch.device("cpu"))

    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert abs(float(a["a.weight"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(a["c.weight"].std()) - 144 ** -0.5) < 0.02
    assert torch.equal(a["a.bias"], torch.zeros(64)) and torch.equal(a["n.weight"],
                                                                    torch.ones(64))
    assert float(a["bin_score"]) == 1.0 and torch.equal(a["bn.running_var"], torch.ones(32))
    assert abs(float(a["query_embed"].std()) - 1.0) < 0.15
