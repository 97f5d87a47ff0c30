"""Per-region market presets.

Calibrated parameters live in ``repro_torch/configs/market_presets.json``,
a byte-identical copy of the reference package's calibration. A region
without a calibration gets a structurally sensible default with the
paper's p_avg, seeded by a stable CRC-32 of its name, so the default is
the same in every process.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

from repro_torch.core.regions import PAPER_TABLE2
from repro_torch.energy.markets import MarketParams

_PRESET_PATH = Path(__file__).resolve().parent.parent / "configs" / \
    "market_presets.json"


def default_seed(region: str) -> int:
    """Seed of an uncalibrated region: CRC-32 of its name, in [0, 2**31)."""
    return zlib.crc32(region.encode("utf-8")) % (2 ** 31)


def _defaults(region: str) -> MarketParams:
    row = PAPER_TABLE2.get(region)
    p_avg = row.p_avg if row is not None else 80.0
    return MarketParams(p_avg=p_avg, seed=default_seed(region))


def _load_baked() -> dict:
    if _PRESET_PATH.exists():
        return json.loads(_PRESET_PATH.read_text())
    return {}


REGION_PRESETS = sorted(PAPER_TABLE2.keys())


def region_params(region: str, seed: int | None = None) -> MarketParams:
    """Calibrated ``MarketParams`` for a Table II region."""
    baked = _load_baked().get(region)
    params = _defaults(region) if baked is None else MarketParams(**baked)
    if seed is not None:
        params = params.replace(seed=seed)
    return params
