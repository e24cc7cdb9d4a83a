"""The whole request's share of the card's peak: the frozen work bound
of every denoiser step of the profiled requests (``bench.workcount``)
over their unprofiled wall."""


def read(rec):
    prof, work = rec["profile"], rec["work"]
    if prof is None or work is None or prof["wall_s"] <= 0:
        return None
    return 100.0 * sum(work["request"]) / prof["wall_s"]
