"""device_idle.stream: 1 - device-busy time / traced time over the
traced first part of the stream's window, in percent."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0 or not rec.trace.busy:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)
