"""The 95th percentile of every request completed in the window, each
timed from its hand-over to ``ServeEngine.serve`` until ``serve``
returned its images."""
import statistics


def read(rec):
    lat = [s.latency_s for s in rec["served"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
