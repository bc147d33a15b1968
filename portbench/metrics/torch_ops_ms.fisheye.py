"""torch_ops_ms of the fisheye cell: see portbench/readers.py."""

from portbench.readers import torch_ops_ms as read  # noqa: F401
