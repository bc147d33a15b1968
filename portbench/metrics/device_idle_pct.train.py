"""device_idle_pct of the train cells: see portbench/readers.py."""

from portbench.readers import device_idle_pct as read  # noqa: F401
