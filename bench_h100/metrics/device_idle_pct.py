"""The share of the traced window in which no operation ran on the device.

It reads ``device_idle_pct.lanes`` and ``device_idle_pct.scene_end``, one
name for each end-to-end metric it moves (``manifest.reader``)."""


def read(record):
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
