"""K1 (knn_window): the least time of its window searches in the window over
its device time, in %."""

from gpubench.harness import readers


def read(run):
    return readers.roofline(run, "knn_window")
