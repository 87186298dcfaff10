"""Device ms per optimizer step in the device operations that are not the
program's kernels: the residual rows' memset, the image reduction, the loss,
the cotangents and Adam."""


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("device_ops"):
        return None
    return 1e3 * rec["tensor_ops_s"] / rec["steps"]
