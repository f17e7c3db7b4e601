"""The tooling scripts of odam_torch against the JAX package's, on the CPU.

- the analytic FLOP counters of ``odam_torch.scripts.bench_batched_detection``
  equal those of the root ``scripts/bench_batched_detection.py`` and
  ``scripts/profile_batched_detector.py`` exactly;
- ``fused_attention`` and ``flash_attention`` at ``bench_attention``'s key
  lengths, 400 and 1050 (B and H cut), against JAX's Pallas kernels in
  interpret mode, at tests/test_aux.py's bars (2e-5 fused, 3e-5 flash): on
  the CPU the wrappers run their plain version; the CUDA kernels are held to
  it on the card by ``chip_smoke.py``;
- ``ResNet(return_stages=(k,))`` equals JAX's and the full ResNet's stage k,
  and runs no deeper stage (``profile_batched_detector --per_stage`` times
  these prefixes);
- ``lm_envelope_sweep``: ``build_batch`` against JAX's, and ``run_sweep`` at
  a tiny size per cell;
- each tool's ``main`` with ``--device cpu`` at a tiny size.
"""
import importlib
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.models import convert
from odam_torch.models import resnet as t_resnet
from odam_torch.ops import cuda_attention, kernels
from odam_torch.scripts import bench_batched_detection as t_bbd
from odam_torch.scripts import lm_envelope_sweep as t_sweep
from odam_tpu.models import detr as j_detr
from odam_tpu.models import resnet as j_resnet
from odam_tpu.ops import pallas_attention
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
FUSED_ATOL = 2e-5   # tests/test_aux.py:317
FLASH_ATOL = 3e-5   # tests/test_aux.py:213


def _jax_script(name):
    """A root ``scripts/`` module (they import their neighbours by name)."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  os.path.join(scripts, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ FLOP counters

@pytest.mark.parametrize("h,w", [(800, 1071), (160, 208)])
def test_flop_counters_equal_jax(h, w):
    jb, jp = _jax_script("bench_batched_detection"), _jax_script("profile_batched_detector")
    assert t_bbd.conv_flops_resnet50(h, w) == jb.conv_flops_resnet50(h, w)
    assert t_bbd.conv_flops_per_stage(h, w) == jp.conv_flops_per_stage(h, w)
    c = j_detr.DETRConfig()
    _, hw = jb.conv_flops_resnet50(h, w)
    dims = (c.num_queries, c.hidden_dim, c.dim_feedforward, c.enc_layers, c.dec_layers)
    assert t_bbd.transformer_flops(hw[0] * hw[1], *dims) == jb.transformer_flops(
        hw[0] * hw[1], *dims)
    L = (h // 32) * (w // 32)
    assert t_bbd.transformer_heads_flops(L, *dims) == jp.transformer_flops(L, *dims)
    assert sum(t_bbd.conv_flops_per_stage(h, w).values()) == t_bbd.conv_flops_resnet50(h, w)[0]


# ------------------------------------------------- attention at long keys

@pytest.mark.parametrize("kernel,Lk,H,dh", [("fused_attention", 1050, 2, 32),
                                            ("fused_attention", 400, 2, 64),
                                            ("flash_attention", 1050, 2, 32),
                                            ("flash_attention", 400, 2, 64)])
def test_long_key_attention_matches_pallas(kernel, Lk, H, dh):
    """bench_attention's 1050-token encoder and 400-key fuser with B 1 and
    H 2 (of 8 and 4), 7 padded keys at the tail, against JAX's kernel in
    interpret mode (flash with block_k 256, as bench_attention calls it)."""
    B, Lq = 1, 24
    rng = np.random.default_rng(Lk + dh)
    q, k, v = (rng.normal(size=(B, L, H, dh)).astype(np.float32) for L in (Lq, Lk, Lk))
    kpm = np.zeros((B, Lk), bool)
    kpm[:, -7:] = True
    extra = {"block_k": 256} if kernel == "flash_attention" else {}
    want = getattr(pallas_attention, kernel)(*map(jnp.asarray, (q, k, v, kpm)),
                                             interpret=True, **extra)
    before = kernels.counts("PLAIN_CALLS")[kernel]
    got = getattr(cuda_attention, kernel)(*map(torch.from_numpy, (q, k, v, kpm)))
    assert kernels.counts("PLAIN_CALLS")[kernel] == before + 1
    atol = FUSED_ATOL if kernel == "fused_attention" else FLASH_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


# ------------------------------------------------------- ResNet prefixes

@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_resnet_prefix_stops_after_its_stage(k):
    """A one-block-a-stage ResNet at 64x64: asked for stage k, it gives
    JAX's stage k (f32, atol 1e-4 + rtol 1e-4, as the stem test) and the
    full ResNet's stage k exactly, and runs no block of a later stage."""
    img = np.random.default_rng(k).normal(size=(2, 64, 64, 3)).astype(np.float32)
    full = t_resnet.ResNet((1, 1, 1, 1), (1, 2, 3, 4))
    convert.init_flax_like_(full, 7)
    full.eval()
    prefix = t_resnet.ResNet((1, 1, 1, 1), (k,)).eval()
    prefix.load_state_dict(full.state_dict())
    ran = []
    for name, mod in prefix.named_children():
        if name.startswith("layer"):
            mod.register_forward_hook(lambda m, i, o, name=name: ran.append(name))
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = prefix(x)
        want_full = full(x)
    assert list(got) == [k]
    assert ran == [f"layer{s}_0" for s in range(1, k + 1)]
    torch.testing.assert_close(got[k], want_full[k], rtol=0, atol=0)
    jm = j_resnet.ResNet(stage_sizes=(1, 1, 1, 1), return_stages=(k,))
    want = jax.jit(jm.apply)({"params": convert.state_dict_to_flax(full)}, jnp.asarray(img))
    np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------- LM envelope

SWEEP = dict(n_views=8, n_samples=32, lm_iters=3, adam_iters=5)
SWEEP_IOU_ATOL = 2e-3   # per cell: f32 solves in another order, a few iterations
SWEEP_RESID_ATOL = 1e-3  # normalized residuals: a thousandth of the mean box diagonal


def test_lm_envelope_sweep_matches_jax():
    """``build_batch`` equals JAX's (the corners in f32 as JAX's, the boxes
    through the same float64 projection: within 1e-4 px); ``run_sweep`` at
    8 views x 32 samples, 3 LM and 5 Adam iterations gives each cell's LM
    and Adam IoU within SWEEP_IOU_ATOL of JAX's, the residuals within
    SWEEP_RESID_ATOL, and the same corners."""
    js = _jax_script("lm_envelope_sweep")
    jargs, jcells, jgts = js.build_batch(n_views=8)
    targs, tcells, tgts = t_sweep.build_batch(n_views=8, device="cpu")
    assert tcells == jcells
    np.testing.assert_allclose(tgts, jgts, rtol=0, atol=1e-6)
    for j, t in zip(jargs[0], targs[0]):       # the SQParams of the init
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    for i in (1, 3, 4, 5):                     # boxes, view mask, P_cw, optimize mask
        np.testing.assert_allclose(targs[i].numpy(), np.asarray(jargs[i]), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(targs[2].numpy(), np.asarray(jargs[2]))   # box mask

    jrows, jagg, jcorners = js.run_sweep(**SWEEP, verbose=False)
    trows, tagg, tcorners = t_sweep.run_sweep(**SWEEP, verbose=False, device="cpu")
    assert [r[:3] for r in trows] == [r[:3] for r in jrows]
    got, want = np.array([r[3:] for r in trows]), np.array([r[3:] for r in jrows])
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SWEEP_IOU_ATOL)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0, atol=SWEEP_RESID_ATOL)
    assert tcorners == jcorners


def test_lm_envelope_sweep_functions_default_to_the_card(monkeypatch):
    """``build_batch`` and ``run_sweep`` without a device run on the card:
    on a host without one they raise ``resolve_device``'s error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, kwargs in ((t_sweep.build_batch, {"n_views": 2}),
                       (t_sweep.run_sweep, dict(SWEEP, verbose=False))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(**kwargs)


# ------------------------------------------------------------- the tools

TINY = ("--device", "cpu", "--dtype", "float32")
TOOLS = {
    "bench_attention": (["--device", "cpu", "--iters", "1", "--cases", "fuser_w100_48trk",
                         "--dtype", "float32"],
                        ["device: cpu", "fuser_w100_48trk: plain"]),
    "profile_pipeline": ([*TINY, "--h", "64", "--w", "64", "--iters", "1", "--frames", "1"],
                         ["device: cpu", "detr forward:", "postprocess + NMS:",
                          "track re-projection:", "associator forward:", "composed step"]),
    "ab_step_input": ([*TINY, "--img_h", "64", "--img_w", "64", "--frames", "1"],
                      ["device: cpu", "float32: median", "uint8: median", "yuv420: median",
                       "yuv420: ", "track ids equal float32's: {'float32': True, "
                       "'uint8': True, 'yuv420': True}"]),
    "bench_scene_parallel": ([*TINY, "--img_h", "64", "--img_w", "64", "--lanes", "1", "2",
                              "--passes", "1"],
                             ["device: cpu", "S=1: aggregate median", "S=2: aggregate median",
                              "x vs S=1)"]),
    "bench_batched_detection": ([*TINY, "--img_h", "64", "--img_w", "64", "--batches", "1,2",
                                 "--iters", "1"],
                                ["device: cpu; dtype float32; peak 67.0 TFLOP/s", "model: ~",
                                 "batch   1: device", "batch   2: device",
                                 "MFU not measured (cpu)", "best device-resident: batch"]),
    "profile_batched_detector": ([*TINY, "--img_h", "64", "--img_w", "64", "--batch", "1",
                                  "--passes", "1", "--reps", "1", "--per_stage", "--stem",
                                  "s2d"],
                                 ["device: cpu", "B=1  full", "backbone:", "transformer+heads:",
                                  "postprocess:", "whole-program MFU not measured (cpu)",
                                  "per-stage backbone attribution (stem=s2d", "stem:",
                                  "layer4:", "prefix(4)"]),
    "lm_envelope_sweep": (["--device", "cpu", "--views", "8", "--samples", "32", "--lm_iters",
                           "2", "--adam_iters", "3"],
                          ["device: cpu", "worst-over-seeds IoU delta", "  0.70  ",
                           "corners with all-in-envelope cells", "normalized residual"]),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_main_on_the_cpu(tool, capsys, monkeypatch):
    """Each tool's ``main`` at a tiny size prints its lines, the device first."""
    monkeypatch.setenv("ODAM_AB_PASSES", "1")
    monkeypatch.setenv("ODAM_BENCH_FRAMES", "1")
    argv, lines = TOOLS[tool]
    result = importlib.import_module(f"odam_torch.scripts.{tool}").main(argv)
    out = capsys.readouterr().out
    assert out.startswith("device: cpu"), out[:200]
    for line in lines:
        assert line in out, (line, out)
    assert result


def test_tools_run_on_the_card_unless_asked(monkeypatch, tmp_path):
    """Without a card and without ``--device cpu`` every tool raises before
    it runs anything (the crash demo before it makes its work directory)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in TOOLS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            importlib.import_module(f"odam_torch.scripts.{tool}").main([])
    from odam_torch.scripts import crash_recovery_demo

    with pytest.raises(RuntimeError, match="device='cpu'"):
        crash_recovery_demo.main(["--workdir", str(tmp_path / "crash")])
    assert not (tmp_path / "crash").exists()
