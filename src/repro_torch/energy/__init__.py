"""Energy-market substrate: the structural synthetic spot-market
generator, its per-region calibrated presets, the moving-block
bootstrap of price traces (`ensemble`), the replayed price stream the
runtime scheduler reads (`stream`), the forecasting baselines the live
operator runs (`forecast`), and the loader for real SMARD CSV exports
(`smard`)."""

from repro_torch.energy.ensemble import block_bootstrap
from repro_torch.energy.forecast import (mae, mase, seasonal_naive,
                                         seasonal_naive_batch,
                                         similar_day_ar,
                                         similar_day_ar_batch)
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
    "seasonal_naive",
    "seasonal_naive_batch",
    "similar_day_ar",
    "similar_day_ar_batch",
    "mae",
    "mase",
]
