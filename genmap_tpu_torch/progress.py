"""Throttled terminal progress meter.

Mirrors the reference's progress printer (GenMap src/common.hpp:87-131):
carriage-return overwrite, percentage with two decimals (truncated), optional
"File i / n." prefix for multi-file runs.  Auto-disabled when stdout is not a
terminal (keeps test and pipeline logs clean).
"""

from __future__ import annotations

import math
import os
import sys


class Progress:
    def __init__(self, total: int, file_no: int = 1, total_files: int = 1):
        self.total = max(1, total)
        self.count = 0
        self.file_no = file_no
        self.total_files = total_files
        self.enabled = sys.stdout.isatty() and os.environ.get(
            "GENMAP_TPU_PROGRESS", "1"
        ) != "0"
        self._step = 511  # print roughly every 512 increments

    def add(self, n: int) -> None:
        if not self.enabled:
            return
        before = self.count
        self.count += n
        if (before // (self._step + 1)) != (self.count // (self._step + 1)):
            self._print(self.count / self.total)

    def _print(self, frac: float) -> None:
        pct = math.trunc(frac * 10000) / 100
        if self.total_files == 1:
            sys.stdout.write(f"\rProgress: {pct}%\x1b[K")
        else:
            sys.stdout.write(
                f"\rFile {self.file_no} / {self.total_files}. Progress: {pct}%\x1b[K"
            )
        sys.stdout.flush()

    def finish(self) -> None:
        if not self.enabled:
            return
        if self.total_files == 1:
            sys.stdout.write("\rProgress: 100.00%\x1b[K\n")
        else:
            sys.stdout.write(
                f"\rFile {self.file_no} / {self.total_files}. Progress: 100.00 %\x1b[K"
            )
            if self.file_no == self.total_files:
                sys.stdout.write("\n")
        sys.stdout.flush()
