"""1 minus the union of the profiler's device intervals over the
unprofiled wall of the same requests."""


def read(rec):
    prof = rec["profile"]
    if prof is None or not prof["events"] or prof["wall_s"] <= 0:
        return None
    from bench.timing import union_s
    return 100.0 * (1.0 - union_s(prof["events"]) / prof["wall_s"])
