"""Mean ms a train step that the device sits idle inside the port's
step/backward span (ao_tpu_torch/utils/tracing.py)."""

from gpubench.harness import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "step/backward")
