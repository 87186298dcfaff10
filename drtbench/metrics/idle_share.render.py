"""The share of the profiled stretch of images in which no device operation
runs, in %."""


def read(rec: dict):
    if rec.get("kind") != "render" or not rec.get("device_ops"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
