"""Host ms per optimizer step from the call into the block of steps to its
return, before the losses are read, over every block of the measured window
(outside the profiler)."""


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("device_ops"):
        return None
    return 1e3 * rec["enqueue_s_per_step"]
