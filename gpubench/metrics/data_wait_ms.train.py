"""Mean host ms a train step waits for the loader's next batch (the benchmark's
span around next(loader))."""

from gpubench.harness import readers


def read(run):
    return readers.span_mean_ms(run, "data_wait")
