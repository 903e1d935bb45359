"""Host seconds the program spent capturing CUDA graphs over the run,
warm-ups included (a fresh checkout's kernel builds fall in the first):
tracing.counters()['capture_s'] of quflow_tpu_torch, where it captured."""

from portbench.spans import program_counters


def read(run):
    counts = program_counters()
    if not counts or not counts["captures"]:
        return None
    return counts["capture_s"]
