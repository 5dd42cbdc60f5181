"""Experiment drivers built on the CLI (port of `cgs_tpu/sandbox/`)."""
