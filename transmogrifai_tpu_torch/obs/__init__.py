"""The port's observability plane, as far as it is ported: the counters of
`metrics.py`, the run timeline's spans (`trace.py`), their Chrome-trace
and JSONL exports (`export.py`) and the goodput rollup (`goodput.py`)."""
