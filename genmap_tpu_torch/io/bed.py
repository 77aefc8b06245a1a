"""Minimal BED3 reader (reference: src/mappability.hpp:253-269)."""

from __future__ import annotations


def read_bed3(path: str) -> dict[str, list[tuple[int, int]]]:
    """Read a BED3 file into {seq_id: [(begin, end), ...]} preserving order."""
    intervals: dict[str, list[tuple[int, int]]] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                parts = line.split()
            seq_id, begin, end = parts[0], int(parts[1]), int(parts[2])
            intervals.setdefault(seq_id, []).append((begin, end))
    return intervals
