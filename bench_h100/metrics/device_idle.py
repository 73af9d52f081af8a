"""device_idle: the share of the traced steps' span on the host clock in
which no kernel, copy or fill ran on the device (the union of their
intervals), from a trace of the device's activity alone."""


def read(ctx):
    if ctx["busy"] is None:
        return None
    busy_us, window_us = ctx["busy"]
    if window_us <= 0:
        return None
    return 100. * (1. - busy_us / window_us)
