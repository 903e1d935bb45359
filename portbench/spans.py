"""The port's own spans and counters (``quflow_tpu_torch.tracing``) as
the metric readers take them.  The spans are on only inside a profiler
session, so what they hold is the profiled call of a ``--trace 1`` run.
A program without that module (a commit before it) gives None, and so
does every reader of it."""


def program_spans():
    """The spans the program kept (tracing.spans()), or None."""
    try:
        from quflow_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def program_counters():
    """The program's counters (tracing.counters()), or None."""
    try:
        from quflow_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.counters()


def integrator_calls(spans):
    """The ``quflow.solve.integrate`` spans: one integrator call each."""
    return [s for s in spans if s["name"] == "quflow.solve.integrate"]
