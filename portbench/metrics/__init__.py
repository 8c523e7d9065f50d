"""One reader a metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``: ``read(ctx) -> float | None`` (``harness.Ctx``).  A
quantity measured on both drivers' paths has one reader file a path,
``<quantity>.fused.py`` and ``<quantity>.map.py``, which take the shared
reading from ``<quantity>.py``: the device-paced fused path and the
host-paced step-by-step path spread differently, so each keeps its own
bound.  ``yardstick.py`` (peaks, operations, bytes) and ``timeline.py``
(the traced window) are shared by the readers."""
