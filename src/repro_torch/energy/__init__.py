"""Energy-market substrate: the structural synthetic spot-market
generator, its per-region calibrated presets, the moving-block
bootstrap of price traces (`ensemble`), and the replayed price stream
the runtime scheduler reads (`stream`). Forecasting and real-data
loaders come with the live-operation slice."""

from repro_torch.energy.ensemble import block_bootstrap
from repro_torch.energy.markets import (MarketData, MarketDraws,
                                        MarketParams, generate_market,
                                        generate_markets, market_draws)
from repro_torch.energy.presets import REGION_PRESETS, region_params
from repro_torch.energy.stream import PriceStream

__all__ = [
    "block_bootstrap",
    "MarketParams",
    "MarketData",
    "MarketDraws",
    "generate_market",
    "generate_markets",
    "market_draws",
    "PriceStream",
    "region_params",
    "REGION_PRESETS",
]
