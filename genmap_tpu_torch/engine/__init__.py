"""Per-file orchestration and the brute-force oracle."""
