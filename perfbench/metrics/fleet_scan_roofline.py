"""Backtest kernel: the least time of the traced requests' hard scans
(`harness.roofline.fleet_scan` at each request's rows, hours and
markets) over the device time of the kernels that do that work."""

from harness import roofline

KERNELS = r"fleet_scan_kernel"


def read(run):
    tr, sh = run.trace, run.shape
    if tr is None or not sh.get("traced_requests"):
        return None
    spent = tr.device_seconds(KERNELS)
    if spent <= 0:
        return None
    need = sh["traced_requests"] * roofline.fleet_scan(
        sh["rows"], sh["hours"], sh["markets"])
    return 100.0 * need / spent
