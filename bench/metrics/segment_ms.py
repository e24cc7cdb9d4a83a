"""The median request's summed ``plan.segment`` spans (``obs/trace.py``;
with tracing on each span synchronizes the card, so it holds the
segment's device work)."""
import statistics


def read(rec):
    per = [sum(s.segments_s) for s in rec["served"] if s.segments_s]
    return statistics.median(per) * 1e3 if per else None
