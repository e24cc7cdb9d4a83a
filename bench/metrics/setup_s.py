"""From process start to the first timed request: imports, the kernels
loaded (built, in a checkout's first run), the store drawn on the
device, the engine built and the cell's batch shapes warmed."""


def read(rec):
    return rec["setup_s"]
