"""``device_idle_pct`` in the cells of the ``map_steps`` driver (a bound of
its own); the reading is ``device_idle_pct.py``'s."""
from portbench.metrics.device_idle_pct import read  # noqa: F401
