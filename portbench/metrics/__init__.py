"""Per-layer metric readers, one file per metric, found by name."""
