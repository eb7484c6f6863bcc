"""host_cpu_util.stream: the process's CPU seconds in the window over the
window times the cores the process may use, in percent."""


def read(rec):
    if rec.cpu is None:
        return None
    cpu_s, cores = rec.cpu
    t0, t1 = rec.window
    return 100.0 * cpu_s / ((t1 - t0) * cores)
