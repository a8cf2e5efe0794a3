"""dispatch_ms (ms): host time of the call that dispatches one forward,
which returns before the card finishes (`time.perf_counter` around it),
the mean over the traced run's window, whose batches run with the profiler
off."""


def read(m):
    if not m.dispatch_s:
        return None
    return 1e3 * sum(m.dispatch_s) / len(m.dispatch_s)
