"""Shared pieces of the harness: manifest, shapes, counters, traces."""
