"""Device ms a fixed-point iteration of the adaptive loop, over the
profiled call: the CUDA-event ms of the program's ``quflow.runner.launch``
spans (the WHILE graphs' launches, their heads and tails with them) over
the iterations that the same calls' reads of the loop's counts return
(the ``iterations`` of their ``quflow.host_read`` spans)."""

from portbench.spans import program_spans


def read(run):
    spans = program_spans()
    if not spans:
        return None
    iterations = {}
    for s in spans:
        if s["name"] == "quflow.host_read" and "iterations" in s["attrs"]:
            iterations[s["call"]] = (iterations.get(s["call"], 0)
                                     + s["attrs"]["iterations"])
    launches = [s["device_ms"] for s in spans
                if s["name"] == "quflow.runner.launch"
                and s["call"] in iterations]
    if not launches or None in launches or not sum(iterations.values()):
        return None
    return sum(launches) / sum(iterations.values())
