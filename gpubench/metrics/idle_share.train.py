"""The share of the train window with no kernel on the device (the union of the
kernels' intervals), in %."""

from gpubench.harness import readers


def read(run):
    return readers.idle_share(run)
