"""Trajectories x steps completed in the window over the window's host
seconds, every output's host copy included."""


def read(run):
    return run.state_steps / run.window_s
