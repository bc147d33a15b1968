"""graph_launch_us of the train cells: see portbench/readers.py."""

from portbench.readers import graph_launch_us as read  # noqa: F401
