"""The train window's model FLOPs (three forwards a step) over its time at the
stated precision's peak, in %."""

from gpubench.harness import readers


def read(run):
    return readers.mfu(run)
