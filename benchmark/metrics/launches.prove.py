"""launches.prove: kernel launches per proof, the port's exact counter
(cuda_curve.LAUNCHES) summed over each prove of the window."""


def read(rec):
    if not any(rec.launches):
        return None
    return sum(rec.launches) / len(rec.launches)
