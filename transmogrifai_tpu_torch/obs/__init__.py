"""The port's observability plane, as far as it is ported: the counters
of `metrics.py`."""
