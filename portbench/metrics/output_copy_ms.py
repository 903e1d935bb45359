"""The mean host ms of one output's copy to the host (the benchmark's
span around the callback's copy), over the window."""


def read(run):
    copies = run.recorder.copy_s
    return sum(copies) / len(copies) * 1e3 if copies else None
