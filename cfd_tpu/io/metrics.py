"""Structured per-step metrics logging.

The reference logs ANSI-colored stdout rows only (cavity-01.cpp:769-773;
channel adds the PPE residual column, channel-01.cpp:762-768) — write-only
observability. This logger keeps the same column set, adds wall-time and
cell-updates/sec (bench.py's headline unit), and persists rows to
JSONL and/or CSV for regression tracking (SURVEY.md section 5.5).
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path


class MetricsLog:
    """Collects per-interval metric rows; optionally mirrors to JSONL/CSV.

    Columns: step, time, max_divergence, avg_kinetic_energy, poisson_iters,
    poisson_residual (+ wall_seconds, cell_updates_per_sec when provided).
    """

    def __init__(self, jsonl_path: str | Path | None = None,
                 csv_path: str | Path | None = None):
        self.rows: list[dict] = []
        self._jsonl = Path(jsonl_path) if jsonl_path else None
        self._csv = Path(csv_path) if csv_path else None
        self._csv_writer = None
        self._csv_file = None
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def append(self, row: dict) -> None:
        self.rows.append(row)
        if self._jsonl is not None:
            with self._jsonl.open("a") as f:
                f.write(json.dumps(row) + "\n")
        if self._csv is not None:
            new = self._csv_file is None
            if new:
                self._csv_file = self._csv.open("w", newline="")
                self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=list(row))
                self._csv_writer.writeheader()
            self._csv_writer.writerow(row)
            self._csv_file.flush()

    def close(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None
