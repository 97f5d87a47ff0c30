"""Loader for SMARD-style market CSV exports (semicolon-separated, German
number formatting) and a generic single-column loader.

The paper sources Germany's 2024 day-ahead prices from SMARD [7]. When the
real export is available, drop it next to your config and point
``--prices path.csv`` at it; every model entry point consumes the result
identically to a synthetic series.

Malformed rows are counted, not silently dropped: both loaders warn when
more than ``max_skip_frac`` of the data rows fail to parse and raise when
*nothing* parses — a mis-pointed ``column`` index fails loudly instead of
returning a short (or empty) series that corrupts every downstream
statistic. Per-load totals are available via ``return_stats=True``.
"""

from __future__ import annotations

import csv
import io
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np

from repro_torch import obs
from repro_torch.energy.stream import ffill_with_staleness


class LoadStats(NamedTuple):
    """Row accounting of one CSV load."""

    n_rows: int       # data rows seen (header excluded)
    n_parsed: int     # rows that yielded a finite price
    n_skipped: int    # unparseable / too-short rows
    n_nan: int        # parsed but empty ("-"/blank) price fields
    n_filled: int = 0  # empty hours recovered by fill="ffill"

    @property
    def skip_frac(self) -> float:
        bad = self.n_skipped + self.n_nan - self.n_filled
        return bad / self.n_rows if self.n_rows else 0.0

    def __str__(self) -> str:
        filled = f", {self.n_filled} filled" if self.n_filled else ""
        return (f"{self.n_rows} data rows: {self.n_parsed} parsed, "
                f"{self.n_skipped} unparseable, {self.n_nan} empty"
                f"{filled} ({self.skip_frac:.1%} bad)")


def _emit_load_event(stats: LoadStats, path, what: str,
                     action: str) -> None:
    """Structured telemetry mirror of the loader's warn/raise paths —
    one ``loader.skipped_rows`` event whose payload is exactly the
    `LoadStats` fields plus the loader name and the action taken."""
    obs.trace_event("loader.skipped_rows", {
        "loader": what, "path": str(path), "n_rows": stats.n_rows,
        "n_parsed": stats.n_parsed, "n_skipped": stats.n_skipped,
        "n_nan": stats.n_nan, "n_filled": stats.n_filled,
        "skip_frac": stats.skip_frac, "action": action})
    obs.counter("loader.skipped_rows").inc(stats.n_skipped + stats.n_nan)


def _finalize(values: list, stats: LoadStats, path, what: str,
              max_skip_frac: float, return_stats: bool,
              fill: str | None = None):
    if fill not in (None, "ffill"):
        raise ValueError(f"{what}: unknown fill mode {fill!r}")
    arr = np.asarray(values, dtype=np.float64)
    if stats.n_rows and stats.n_parsed == 0:
        _emit_load_event(stats, path, what, "raise")
        raise ValueError(
            f"{what}: no {path} row parsed ({stats}) — "
            "wrong column index or not a price CSV?")
    if fill == "ffill" and np.isnan(arr).any():
        arr, stale = ffill_with_staleness(arr)
        stats = stats._replace(n_filled=int((stale > 0).sum()))
    else:
        arr = arr[~np.isnan(arr)]
    if stats.skip_frac > max_skip_frac:
        _emit_load_event(stats, path, what, "warn")
        warnings.warn(
            f"{what}: skipped rows of {path} ({stats}; over the "
            f"{max_skip_frac:.0%} threshold) — "
            "check the column index / file format", stacklevel=3)
    elif stats.n_skipped or stats.n_nan:
        _emit_load_event(stats, path, what, "ok")
    return (arr, stats) if return_stats else arr


def _parse_german_float(s: str) -> float:
    s = s.strip().replace(".", "").replace(",", ".")
    if s in ("", "-"):
        return float("nan")
    return float(s)


def load_smard_csv(path: str | Path, column: int = -1, *,
                   max_skip_frac: float = 0.05,
                   return_stats: bool = False,
                   fill: str | None = None):
    """Load a SMARD 'Marktdaten' CSV export; returns EUR/MWh samples.

    SMARD exports are ';'-separated with a header row; price columns use
    German decimal commas. ``column`` selects the price column (default:
    last). With ``return_stats=True`` returns ``(prices, LoadStats)``.

    Real SMARD year exports carry empty price fields ("-") on DST-switch
    and outage hours. By default those hours are *dropped* (shortening
    the series and shifting hour-of-day alignment); ``fill="ffill"``
    instead carries the last published price forward, keeps the series
    full-length, and reports the repair count in ``LoadStats.n_filled``
    (filled hours no longer count toward the skip-fraction warning).
    """
    text = Path(path).read_text(encoding="utf-8-sig")
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    out: list = []
    n_rows = n_skipped = n_nan = 0
    for row in rows[1:]:
        if not row:
            continue                     # blank line, not a data row
        n_rows += 1
        if len(row) <= abs(column) - (1 if column < 0 else 0):
            n_skipped += 1
            continue
        try:
            v = _parse_german_float(row[column])
        except ValueError:
            n_skipped += 1
            continue
        if np.isnan(v):
            n_nan += 1
        out.append(v)
    stats = LoadStats(n_rows=n_rows, n_parsed=n_rows - n_skipped - n_nan,
                      n_skipped=n_skipped, n_nan=n_nan)
    return _finalize(out, stats, path, "load_smard_csv", max_skip_frac,
                     return_stats, fill=fill)


def load_price_csv(path: str | Path, *, max_skip_frac: float = 0.05,
                   return_stats: bool = False):
    """Generic loader: one price per line, or comma-separated single column.

    Leading unparseable lines (one- or multi-line headers, before the
    first value parses) are expected and not counted against the skip
    threshold; unparseable lines *after* data has started are. A file
    with content but no parseable value at all raises.
    """
    text = Path(path).read_text()
    vals: list = []
    n_rows = n_skipped = n_header = 0
    for line in text.splitlines():
        line = line.strip().split(",")[0]
        if not line:
            continue
        try:
            vals.append(float(line))
        except ValueError:
            if not vals:
                n_header += 1            # still inside the header block
            else:
                n_rows += 1
                n_skipped += 1
            continue
        n_rows += 1
    if not vals and (n_rows or n_header):
        _emit_load_event(
            LoadStats(n_rows=n_rows + n_header, n_parsed=0,
                      n_skipped=n_skipped + n_header, n_nan=0),
            path, "load_price_csv", "raise")
        raise ValueError(
            f"load_price_csv: no {path} line parsed "
            f"({n_header} non-numeric lines) — not a price CSV?")
    stats = LoadStats(n_rows=n_rows, n_parsed=n_rows - n_skipped,
                      n_skipped=n_skipped, n_nan=0)
    return _finalize(vals, stats, path, "load_price_csv", max_skip_frac,
                     return_stats)
