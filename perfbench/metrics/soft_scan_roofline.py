"""Soft-scan kernels: the least time of the traced steps' relaxed scans,
forward and backward (`harness.roofline.soft_scan_fwd` / `_bwd`), over
the device time of the kernels that do that work (the soft scan's
untemplated forward and backward kernels)."""

from harness import roofline

KERNELS = r"soft_(fwd|bwd)_kernel\("


def read(run):
    tr, sh = run.trace, run.shape
    if tr is None or not sh.get("traced_jobs"):
        return None
    spent = tr.device_seconds(KERNELS)
    if spent <= 0:
        return None
    b, t, bt = sh["rows"], sh["hours"], sh["block_t"]
    need = sh["traced_jobs"] * sh["steps"] * (
        roofline.soft_scan_fwd(b, t, bt) + roofline.soft_scan_bwd(b, t, bt))
    return 100.0 * need / spent
