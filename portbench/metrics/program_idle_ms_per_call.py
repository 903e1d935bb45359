"""Device ms a call of the integrator that the device waited on the
program's own host code, over the profiled call: the ``idle_ms`` of the
program's spans (quflow_tpu_torch.tracing: the stretches between span
boundaries, CUDA events on the stream, owned by a span whose code queues
no device work; sound inside a WHILE node), the user's callback left
out, over the ``quflow.solve.integrate`` spans."""

from portbench.spans import integrator_calls, program_spans


def read(run):
    spans = program_spans()
    if not spans:
        return None
    calls = integrator_calls(spans)
    idle = [s["idle_ms"] for s in spans if s["idle_ms"] is not None
            and s["name"] != "quflow.solve.callback"]
    if not calls or not idle:
        return None
    return sum(idle) / len(calls)
