"""odam_torch's on-device resize against odam_tpu's on the CPU: the resize
itself against ``jax.image.resize`` and the pipeline with
``resize_on_device``, on seeded tiny models as in
``tests/test_torch_pipeline.py``.  Each test states its bar."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, resize_bilinear_device
from test_torch_pipeline import _assert_tracks_equal, _pose, _tiny_models
from torch_threads import one_torch_thread  # noqa: F401

K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)


def _frames(n, shape=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=shape + (3,), dtype=np.uint8) for _ in range(n)]


def _with_cfg(jpipe, tpipe, **kw):
    """Both pipelines with PipelineConfig fields replaced (JAX's step is
    rebuilt, since it reads the config when it is traced)."""
    jpipe.cfg = dataclasses.replace(jpipe.cfg, **kw)
    jpipe._step = jpipe._build_step()
    tpipe.cfg = dataclasses.replace(tpipe.cfg, **kw)
    return jpipe, tpipe


@pytest.mark.parametrize("src,dst", [((968, 1296), (800, 1071)), ((192, 192), (800, 800))])
def test_device_resize_matches_jax(src, dst):
    """resize_bilinear_device against jax.image.resize(..., "bilinear") on an
    ImageNet-normalized uint8 frame: a downscale (antialiased: the triangle
    kernel widens by the scale) and an upscale, atol 1e-4."""
    img = _frames(1, src, seed=sum(src))[0]
    x = ((img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst + (3,), "bilinear"))
    out = resize_bilinear_device(torch.from_numpy(x), *dst).numpy()
    assert out.shape == dst + (3,)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    batched = resize_bilinear_device(torch.from_numpy(np.stack([x, x[::-1]])), *dst).numpy()
    np.testing.assert_array_equal(batched[0], out)


def test_device_resize_pipeline_matches():
    """resize_on_device, as tests/test_loader.py drives it: raw 96x128 uint8
    frames into a 64x64 sequence over four frames; track ids exact and rows
    within atol 1e-4, as the whole-step test has it."""
    jpipe, tpipe = _with_cfg(*_tiny_models(), resize_on_device=True)
    raw = _frames(4, (96, 128), seed=1)
    for pipe in (jpipe, tpipe):
        pipe.init_sequence(K, 64, 64)
    for f, frame in enumerate(raw):
        jpipe.process_frame(frame, f, _pose(f))
        tpipe.process_frame(frame, f, _pose(f))
    _assert_tracks_equal(jpipe, tpipe, atol=1e-4)
    assert int(tpipe.sequence["log"].count) == 4
