"""``kernel_roofline_pct`` in the cells of the ``map_steps`` driver (a bound of
its own); the reading is ``kernel_roofline_pct.py``'s."""
from portbench.metrics.kernel_roofline_pct import read  # noqa: F401
