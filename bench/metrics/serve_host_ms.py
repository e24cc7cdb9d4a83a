"""The median request's wall outside its ``plan.segment`` spans: the
serving layer's host work (per-row noise draws, bucket padding, the
upload and the copy back)."""
import statistics


def read(rec):
    per = [s.latency_s - sum(s.segments_s) for s in rec["served"]
           if s.segments_s]
    return statistics.median(per) * 1e3 if per else None
