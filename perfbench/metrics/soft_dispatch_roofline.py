"""Soft-dispatch kernels: the least time of the traced steps' entropic
water-fills, forward and backward (`harness.roofline.soft_dispatch_fwd`
/ `_bwd` at the fleet's sites and hours), over the device time of the
kernels that do that work (the water-fill's templated forward and its
two backward kernels)."""

from harness import roofline

KERNELS = r"soft_fwd_kernel<|soft_bwd_(coef|chain)_kernel"


def read(run):
    tr, sh = run.trace, run.shape
    if tr is None or not sh.get("traced_jobs") or not sh.get("sites"):
        return None
    spent = tr.device_seconds(KERNELS)
    if spent <= 0:
        return None
    s, t = sh["sites"], sh["hours"]
    need = sh["traced_jobs"] * sh["steps"] * (
        roofline.soft_dispatch_fwd(s, t, sh["n_bisect"])
        + roofline.soft_dispatch_bwd(s, t))
    return 100.0 * need / spent
