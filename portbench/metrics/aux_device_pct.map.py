"""``aux_device_pct`` in the cells of the ``map_steps`` driver (a bound of
its own); the reading is ``aux_device_pct.py``'s."""
from portbench.metrics.aux_device_pct import read  # noqa: F401
