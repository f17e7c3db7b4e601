"""Attention bench: the plain path, SDPA, and the fused and flash CUDA kernels.

    python -m odam_torch.scripts.bench_attention [--dtype bfloat16] [--iters 30]

Counterpart of ``scripts/bench_attention.py``, at its three shapes: the DETR
encoder (1050 image tokens) and the associator's track-history fuser at
window 100 and 400, each with 7 padded keys at the tail.  Columns:

- ``plain``: ``mha_core`` with ``use_kernels=False`` (JAX's "XLA" column);
- ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention``, a library
  yardstick that the port never calls;
- ``fused`` and ``flash``: the wrappers of :mod:`odam_torch.ops.cuda_attention`
  called directly (flash at every Lk, fused at every Lk too, as JAX's).

Each kernel's error is taken against the f32 plain result.  On the card a
column's time is device milliseconds a call between two CUDA events around
``--iters`` calls (:func:`odam_torch.utils.metrics.time_ms`); on the CPU
(``--device cpu``) the wrappers run their plain versions and the host clock
times them.  The first line names the device (on the card: its name and
power limit).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device

CASES = (
    # (name, B, Lq, Lk, H, dh)
    ("encoder_1050tok", 1, 1050, 1050, 8, 32),
    ("fuser_w100_48trk", 48, 100, 100, 4, 64),
    ("fuser_w400_48trk", 48, 400, 400, 4, 64),
)
MASKED_TAIL = 7
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.bench_attention",
                                 description="Attention kernels against the plain path and "
                                             "SDPA (PyTorch port).")
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cases", nargs="+", default=[c[0] for c in CASES],
                    choices=[c[0] for c in CASES])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line a case; return one dict a case (times in ms, errors
    and the largest |f32 plain| value, and the launches each kernel wrapper
    counted while its column ran)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from ..ops import attention, cuda_attention as ca, kernels
    from ..utils.metrics import device_banner, time_ms

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # the f32 columns in full f32
    dtype = DTYPES[args.dtype]
    print(f"device: {device_banner(dev)}; dtype {args.dtype}", flush=True)

    rng = np.random.default_rng(0)
    rows = []
    for name, B, Lq, Lk, H, dh in CASES:
        D = H * dh
        qkv = [rng.normal(size=(B, L, D)) for L in (Lq, Lk, Lk)]   # every case draws its data
        if name not in args.cases:
            continue
        q, k, v = (torch.from_numpy(x.astype(np.float32)).to(dev, dtype) for x in qkv)
        kpm = torch.from_numpy(np.arange(Lk)[None, :] >= Lk - MASKED_TAIL).repeat(B, 1).to(dev)
        with torch.no_grad():    # f32 math on the inputs as the kernels read them
            ref = attention.mha_core(q.float(), k.float(), v.float(), H, kpm,
                                     use_kernels=False).reshape(B, Lq, H, dh)
        qh, kh, vh = (x.reshape(B, -1, H, dh) for x in (q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (qh, kh, vh))
        keep = ~kpm[:, None, None, :]
        calls = {
            "plain": lambda: attention.mha_core(q, k, v, H, kpm, use_kernels=False),
            "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep),
            "fused": lambda: ca.fused_attention(qh, kh, vh, kpm),
            "flash": lambda: ca.flash_attention(qh, kh, vh, kpm),
        }
        row = {"case": name, "shape": {"B": B, "Lq": Lq, "Lk": Lk, "H": H, "dh": dh},
               "dtype": args.dtype, "masked_tail": MASKED_TAIL,
               "ref_max_abs": float(ref.abs().max())}
        with torch.no_grad():
            for col in ("fused", "flash"):
                out = calls[col]().float()
                row[f"err_{col}"] = float((out - ref).abs().max())
            for col, fn in calls.items():
                before = kernels.counts("LAUNCHES")
                row[f"{col}_ms"] = time_ms(fn, args.iters, dev)
                if col in ("fused", "flash"):
                    kernel = f"{col}_attention"
                    row[f"{col}_launches"] = kernels.counts("LAUNCHES")[kernel] - before[kernel]
        rows.append(row)
        print(f"{name:>18}: plain {row['plain_ms']:7.3f} ms | sdpa {row['sdpa_ms']:7.3f} ms | "
              f"fused {row['fused_ms']:7.3f} ms (err {row['err_fused']:.2e}) | "
              f"flash {row['flash_ms']:7.3f} ms (err {row['err_flash']:.2e})", flush=True)
    return rows


if __name__ == "__main__":
    main()
