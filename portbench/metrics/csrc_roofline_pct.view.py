"""csrc_roofline_pct of the view cells: see portbench/readers.py."""

from portbench.readers import csrc_roofline_pct as read  # noqa: F401
