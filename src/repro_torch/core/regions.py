"""Regional comparison — paper Section IV-E / Table II.

`PAPER_TABLE2` records the paper's published values (the reproduction
target). `compute_region_row` produces the same row from any price series;
`regional_table` runs the whole study on our calibrated synthetic markets
(or real data when supplied).

The paper fixes the *system* (Lichtenberg's fixed costs and power draw) and
varies only the market: Psi_region = Psi_LB * p_avg_DE / p_avg_region,
because Psi = F / (T * C * p_avg) is inversely proportional to the mean
price. Table II's Psi column follows this rule (e.g. Finland:
2.0 * 77.84 / 46.36 = 3.36), which we replicate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.optimizer import optimal_shutdown
from repro_torch.device import DeviceLike

PSI_LICHTENBERG = 2.0          # paper Section IV-A estimate
P_AVG_GERMANY = 77.84          # EUR/MWh, Germany 2024 (paper Table II)


class RegionRow(NamedTuple):
    region: str
    p_avg: float
    psi: float
    x_be_pct: float            # break-even shutdown fraction [%]
    x_opt_pct: float           # optimal shutdown fraction [%]
    cpc_red_pct: float         # max CPC reduction [%]


# Paper Table II (verbatim); '-' entries (Spain) encoded as None.
PAPER_TABLE2 = {
    "south_australia": RegionRow("south_australia", 59.36, 2.62, 17.55, 1.55, 5.99),
    "finland":         RegionRow("finland",         46.36, 3.36,  8.25, 2.20, 1.76),
    "estonia":         RegionRow("estonia",         87.69, 1.77,  9.24, 2.46, 1.52),
    "germany":         RegionRow("germany",         77.84, 2.00,  3.34, 0.82, 0.57),
    "south_sweden":    RegionRow("south_sweden",    50.05, 3.11,  3.75, 1.22, 0.52),
    "poland":          RegionRow("poland",          96.26, 1.62,  4.04, 1.50, 0.39),
    "netherlands":     RegionRow("netherlands",     77.60, 2.01,  2.54, 0.64, 0.39),
    "great_britain":   RegionRow("great_britain",   85.92, 1.81,  1.12, 0.38, 0.15),
    "france":          RegionRow("france",          58.19, 2.67,  0.53, 0.23, 0.04),
    "spain":           RegionRow("spain",           63.09, 2.47, None, None, None),
}

# Section IV-A headline numbers (Germany 2024, 1 h, Psi = 2).
PAPER_LICHTENBERG = {
    "x_be_pct": 3.32,          # Fig. 3 (Table II lists 3.34 from a
                               # different data source / FX conversion)
    "x_opt_pct": 0.8189,
    "k_opt": 4.9726,
    "cpc_red_pct": 0.5429,
    "p_thresh": 237.84,
}

# Section IV-B (South Australia, AEMO dispatch prices, Psi = 2).
PAPER_SOUTH_AUSTRALIA_IV_B = {
    "x_be_pct": 25.66,
    "x_opt_pct": 3.66,
    "cpc_red_pct": 8.31,
}


def psi_for_region(p_avg_region: float,
                   psi_ref: float = PSI_LICHTENBERG,
                   p_avg_ref: float = P_AVG_GERMANY) -> float:
    """Psi of the Lichtenberg system transplanted into another market."""
    return psi_ref * p_avg_ref / p_avg_region


def compute_region_row(region: str, prices: np.ndarray,
                       psi: float | None = None, *,
                       device: DeviceLike = None) -> RegionRow:
    prices = np.asarray(prices)
    p_avg = float(prices.mean())
    psi_val = float(psi) if psi is not None else psi_for_region(p_avg)
    plan = optimal_shutdown(prices, psi_val, device=device)
    viable = bool(plan.viable)
    return RegionRow(
        region=region,
        p_avg=p_avg,
        psi=psi_val,
        x_be_pct=float(plan.x_break_even) * 100 if viable else None,
        x_opt_pct=float(plan.x_opt) * 100 if viable else None,
        cpc_red_pct=float(plan.cpc_reduction) * 100 if viable else None,
    )


def regional_table(prices_by_region: dict[str, np.ndarray], *,
                   device: DeviceLike = None) -> list[RegionRow]:
    rows = [compute_region_row(r, p, device=device)
            for r, p in prices_by_region.items()]
    rows.sort(key=lambda r: (r.cpc_red_pct is None,
                             -(r.cpc_red_pct or 0.0)))
    return rows
