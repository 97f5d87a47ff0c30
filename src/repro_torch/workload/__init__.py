"""Workload-coupled demand: request traces, the work ledger, and the
coupled backtest. See `repro_torch.workload.trace` for the arrival model,
`repro_torch.workload.queue` for the numpy replay oracle and
`repro_torch.workload.backtest` for the coupled backtest (the ledger
kernels of `repro_torch.kernels.queue_scan` on the card)."""

from repro_torch.workload.backtest import (WorkloadBacktest, WorkloadResult,
                                           realized_cost, workload_backtest)
from repro_torch.workload.queue import (LedgerReplay, ledger_cost,
                                        replay_ledger)
from repro_torch.workload.trace import Workload

__all__ = [
    "LedgerReplay",
    "Workload",
    "WorkloadBacktest",
    "WorkloadResult",
    "ledger_cost",
    "realized_cost",
    "replay_ledger",
    "workload_backtest",
]
