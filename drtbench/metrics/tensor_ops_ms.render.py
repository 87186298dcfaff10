"""Device ms per image in the device operations that are not the program's
kernels: memsets, copies and PyTorch's kernels between them (the image
reduction)."""


def read(rec: dict):
    if rec.get("kind") != "render" or not rec.get("device_ops"):
        return None
    return 1e3 * rec["tensor_ops_s"] / rec["steps"]
