"""The whole lane step's share of the chip's bf16 peak: the model FLOPs of
a frame (DETR and the GNN associator, bench_h100.roofline) times the frames
a second of the run's measured window (the host's clock, before the trace),
over 989 TFLOP/s."""
from bench_h100 import roofline


def read(record):
    steps = record.get("steps") or []
    if not steps or not record.get("window_s"):
        return None
    fps = len(steps) * record["frames_per_unit"] / record["window_s"]
    return 100.0 * record["model_flops_per_frame"] * fps / roofline.PEAK_FLOPS["bfloat16"]
