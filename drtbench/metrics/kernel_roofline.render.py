"""The program's kernels' share of their roofline per image: the bound time of
an image's work (drtbench.work, from the reference's counts) over the device
time of the program's kernels per image in the profiled stretch, in %."""


def read(rec: dict):
    if rec.get("kind") != "render" or not rec.get("device_ops"):
        return None
    if not rec["program_kernel_s"]:
        return None
    return (100.0 * rec["bound_s_per_step"] * rec["steps"]
            / rec["program_kernel_s"])
