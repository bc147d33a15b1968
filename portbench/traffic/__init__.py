"""Traffic kinds: `traffic/<kind>.py` drives one kind of cell. Each has
`run(cell, config, seed, seconds, trace, device) -> dict` (see run.py for
the keys of the dict it returns)."""
