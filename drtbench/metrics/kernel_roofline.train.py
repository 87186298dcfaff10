"""The program's kernels' share of their roofline per optimizer step (two
renders and their adjoints): the bound time of a step's work (drtbench.work,
from the reference's counts) over the device time of the program's kernels
per step in the profiled stretch, in %."""


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("device_ops"):
        return None
    if not rec["program_kernel_s"]:
        return None
    return (100.0 * rec["bound_s_per_step"] * rec["steps"]
            / rec["program_kernel_s"])
