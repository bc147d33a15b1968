"""torch_ops_ms of the view cells: see portbench/readers.py."""

from portbench.readers import torch_ops_ms as read  # noqa: F401
