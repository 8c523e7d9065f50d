"""``gpoints_per_s`` in the cells of the ``map_steps`` driver (a bound of
its own); the reading is ``gpoints_per_s.py``'s."""
from portbench.metrics.gpoints_per_s import read  # noqa: F401
