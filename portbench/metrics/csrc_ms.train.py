"""csrc_ms of the train cells: see portbench/readers.py."""

from portbench.readers import csrc_ms as read  # noqa: F401
