"""Programs the engine built or CUDA graphs it captured after the
warm-up, over the window and the profiled block (``engine._builds`` +
``engine._captures``): a warm server builds nothing."""


def read(rec):
    return rec["built_after_warmup"]
