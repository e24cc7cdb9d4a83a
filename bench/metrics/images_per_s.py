"""Images delivered to the host in the window, over its seconds."""


def read(rec):
    if not rec["served"] or rec["window_s"] <= 0:
        return None
    return sum(s.images for s in rec["served"]) / rec["window_s"]
