"""Command-line entry points of the port (`python -m onepose_tpu_torch`)."""
