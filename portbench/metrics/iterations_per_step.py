"""Fixed-point iterations a step over the window (the integrator's
``stats['iterations']``, the mean a step of each call)."""


def read(run):
    return run.iterations_per_step()
