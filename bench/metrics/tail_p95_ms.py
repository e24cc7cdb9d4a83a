"""``request_p95_ms`` read as a per-layer metric, in the cells whose
tail moves too much from run to run to hold a bound (the host's share
of each request moves it): the 95th percentile of every request that
the traced window completed."""
from bench.manifest import reader

read = reader("request_p95_ms")
