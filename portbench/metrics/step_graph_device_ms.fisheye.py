"""step_graph_device_ms of the fisheye cell: see portbench/stages.py."""

from portbench.stages import step_graph_device_ms as read  # noqa: F401
