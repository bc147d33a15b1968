"""mfu of the train cells: see portbench/readers.py."""

from portbench.readers import mfu as read  # noqa: F401
