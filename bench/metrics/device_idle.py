"""device_idle (%): share of the profiled slice in which no operation ran
on the device (kernels, copies and sets, from the profiler's trace)."""


def read(m):
    if m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
