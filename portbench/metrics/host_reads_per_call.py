"""Device-to-host reads a call of the integrator (tol, counts, residuals,
state), over the profiled call: the program's ``quflow.host_read`` spans
over its ``quflow.solve.integrate`` spans."""

from portbench.spans import integrator_calls, program_spans


def read(run):
    spans = program_spans()
    if not spans:
        return None
    calls = integrator_calls(spans)
    if not calls:
        return None
    reads = sum(s["name"] == "quflow.host_read" for s in spans)
    return reads / len(calls)
