"""Host ms per image from the call into the renderer to its return, before the
benchmark synchronizes, over every image of the measured window (outside the
profiler)."""


def read(rec: dict):
    if rec.get("kind") != "render" or not rec.get("device_ops"):
        return None
    return 1e3 * rec["enqueue_s_per_step"]
