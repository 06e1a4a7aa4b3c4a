"""Stand-alone checks of the port's kernels, run with ``python -m``."""
