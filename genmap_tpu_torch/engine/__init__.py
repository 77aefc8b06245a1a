"""Per-file orchestration (`mappability`) and the brute-force oracle of the
tests (`oracle`)."""
