"""The select stage's share of its roofline: the frozen work bound
(``bench.workcount``) of the profiled requests over the device time of
the kernels that ``bench/kernels/`` files under ``select`` (with the
passes filed as ``previous`` that this stage's kernels launch)."""


def read(rec):
    prof, work = rec["profile"], rec["work"]
    if prof is None or work is None:
        return None
    busy = sum(e - s for (_, s, e), st in zip(prof["events"],
                                              prof["stages"])
               if st == "select")
    if busy <= 0:
        return None
    return 100.0 * sum(work["select"]) / busy
