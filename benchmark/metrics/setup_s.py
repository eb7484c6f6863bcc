"""setup_s: from the start of the run to the window's opening (host
clock): generators, tree, template, the cell's provers and its warm-up."""


def read(rec):
    return rec.setup_s
