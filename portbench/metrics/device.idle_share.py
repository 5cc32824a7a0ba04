"""1 - device busy time over wall time in a traced stretch of one solve
under torch.profiler with device activity only (busy: the union of the
device operations' intervals)."""


def read(run):
    b = run.busy
    if b is None:
        return None
    return 1.0 - b['busy_s'] / b['wall_s']
