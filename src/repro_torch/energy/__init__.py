"""Energy-market substrate: the structural synthetic spot-market
generator, its per-region calibrated presets, and the moving-block
bootstrap of price traces (`ensemble`). Forecasting, streams and
real-data loaders come with the live-operation slice."""

from repro_torch.energy.ensemble import block_bootstrap
from repro_torch.energy.markets import (MarketData, MarketDraws,
                                        MarketParams, generate_market,
                                        generate_markets, market_draws)
from repro_torch.energy.presets import REGION_PRESETS, region_params

__all__ = [
    "block_bootstrap",
    "MarketParams",
    "MarketData",
    "MarketDraws",
    "generate_market",
    "generate_markets",
    "market_draws",
    "region_params",
    "REGION_PRESETS",
]
