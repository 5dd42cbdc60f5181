"""Tools that read what the benchmark's limits and cells are set from."""
