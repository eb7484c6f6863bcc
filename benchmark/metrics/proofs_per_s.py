"""proofs_per_s: proofs completed per second in a stream's window (host
clock).  The stream completes proofs in whole groups, each worker thread
one group at a time, and no group starts after the window's end.  So
each worker counts its groups that complete in the window and the first
that completes after it (started inside), over the time from its last
completion at or before the window's start to the later of the window's
end and its last counted completion: all of the window is inside that
time, so a stall anywhere in it lowers the rate.  The workers' rates add
up."""


def read(rec):
    t0, t1 = rec.window
    by = {}
    for t, thread, _ in sorted(rec.completions):
        by.setdefault(thread, []).append(t)
    wave = rec.traffic["wave"]
    total = 0.0
    for times in by.values():
        before = [t for t in times if t <= t0]
        counted = [t for t in times if t0 < t <= t1]
        counted += [t for t in times if t > t1][:1]
        if not before or not counted:
            return None
        total += wave * len(counted) / (max(t1, counted[-1]) - before[-1])
    return total if by else None
