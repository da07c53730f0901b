"""Command-line entry points, contract-compatible with faldoi_tpu.cli."""
