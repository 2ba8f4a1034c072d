"""K6 (gva_bwd): the least time of its work in the window over its device time,
in %."""

from gpubench.harness import readers


def read(run):
    return readers.roofline(run, "gva_bwd")
