"""The output check that decides ``correct``, and the conservation record.

What the timed path produces is a state on the host at every output.  The
flow is chaotic, so no reference follows a trajectory of thousands of
complex64 steps; it follows each output interval instead.  For the
set-up's interval (from the initial state, which the benchmark made and
both sides get) and for a sample of the window's intervals drawn from the
seed (from the program's output before it; harness.Recorder keeps the
sample as the outputs come), the reference scheme that the configuration
names (``reference/<scheme>.py``) takes the interval's steps in
complex128 and the program's output at its end is compared with the
reference's, every member and component:

    gap = max |W_program - W_reference| / max |W_reference - W_start|,

the error as a share of what the interval changed, each against a limit
of its own (the configuration's ``gaps``; W's by default).  MHD compares
Theta, and W through its stream function P = Delta^-1 W: W changes
through B = Delta Theta, which multiplies Theta's float32 rounding at
degree l by l(l+1), up to N^2, and that noise at high l, which Delta^-1
damps again, hides TF32 in W's own gap (program 0.15 against the
control's 0.31) but not in P's.  The program's own
state between calls (its warm-started dW and its Kahan compensation) is
not the reference's: the reference's iteration ends at the exact
midpoint, which a warm fixed iteration count approaches.  Under a mix
with an ``exit_rule`` the reference takes the same rule, and each
interval's fixed-point iterations, the program's (``stats['iterations']``
times the steps) and the reference's, are compared too: the sum over the
intervals checked of the iterations by which the two differ, against
the limit ``iterations``, which an exit rule that runs to maxit, stops
at minit or ignores tol exceeds (faults.py; stopping at minit misses at
least the one extra iteration of each interval's first step, whose dW
starts from zero).  Both counts are recorded beside each other
(``run.iteration_counts``).  A run over several ranks (ranks.py) holds
every rank's count of each interval (``run.rank_iterations``); the
reference's rule takes its residual over the whole batch, which is the
mesh's max over the ranks, and an interval misses by the most that any
rank's count differs from the reference's, so a rank that decides from
its own members alone misses where the max across the ranks decides.
The window's last output is also read for non-finite values, which a
state keeps once it holds one.
"""

from __future__ import annotations

import math

import numpy as np

from .reference.quantized import Laplacian, hbar
from .reference.scheme import auto_tol

__all__ = ["check_run", "conservation"]


def _as_members(x, run):
    """A host state as complex128 (B, C, N, N)."""
    return np.asarray(x).astype(np.complex128).reshape(
        run.batch, run.components, run.N, run.N)


def _gap(end, ref, start, of, lap):
    """The largest over the members of max |end - ref| / max |ref - start|,
    of the state (``of`` 'state') or of its stream function Delta^-1
    ('stream'); inf where not finite."""
    d, change = end - ref, ref - start
    if of == "stream":
        d, change = lap.solve(d), lap.solve(change)
    g = float((d.abs().amax(dim=(-2, -1))
               / change.abs().amax(dim=(-2, -1))).amax())
    return g if math.isfinite(g) else math.inf


def check_run(run):
    """Compare the run's outputs with the reference; fills ``run.checks``
    and returns (correct, attempted, failed)."""
    import torch

    cell = run.cell
    limits = cell.limits
    device = run.program_device
    exit_rule = cell.traffic.get("exit_rule")
    scheme = cell.reference(run.N, device)
    dt = run.stepsize * hbar(run.N)
    rec = run.recorder
    attempted = rec.count
    # a state that once holds a NaN or an inf keeps one
    failed = int(not np.isfinite(np.sum(rec.last)))

    initial = run.initial.astype(run.dtype).astype(np.complex128)
    # the program's iterations of each interval, one count a rank
    ranks = getattr(run, "rank_iterations", None) or [rec.iterations]
    intervals = [("start", initial, run.setup_output,
                  getattr(run, "rank_setup_iterations", None)
                  or [run.setup_iterations])]
    for k, start, end in sorted(rec.sample, key=lambda x: x[0]):
        intervals.append(("window", start, end, [its[k] for its in ranks]))

    specs = cell.config.get("gaps", {"W": {"component": 0, "of": "state"}})
    labels = ("start", "window")
    gaps = {(n, label): 0.0 for n in specs for label in labels}
    missed = 0.0
    run.iteration_counts = []
    over = 0
    for label, start, end, iterations in intervals:
        S0 = torch.from_numpy(_as_members(start, run)).to(device)
        S1 = torch.from_numpy(_as_members(end, run)).to(device)
        kw = {}
        if exit_rule:
            tol = exit_rule.get("tol", "auto")
            kw = dict(rule="adaptive", maxit=int(exit_rule["maxit"]),
                      minit=int(exit_rule["minit"]),
                      tol=(auto_tol(S0, dt, run.N, run.dtype)
                           if tol == "auto" else float(tol)))
        X1, counts = scheme.run(S0, dt, run.steps_out, **kw)
        bad = False
        for n, spec in specs.items():
            c = spec["component"]
            gap = _gap(S1[:, c], X1[:, c], S0[:, c], spec["of"], scheme.lap)
            bad |= not gap <= limits["gap"][n]
            gaps[n, label] = max(gaps[n, label], gap)
        if exit_rule:
            run.iteration_counts.append([
                iterations[0] if len(iterations) == 1 else iterations,
                sum(counts)])
            misses = [abs(i - sum(counts)) for i in iterations]
            miss = (max(misses) if all(map(math.isfinite, misses))
                    else math.inf)
            bad |= not miss <= limits["iterations"]
            missed += miss
        over += bad and label == "window"
        del S0, S1, X1
    failed += over
    run.checks = {f"gap_{n}_{label}": {"value": gaps[n, label],
                                       "limit": limits["gap"][n]}
                  for n in specs for label in labels}
    if exit_rule:
        run.checks["iterations"] = {"value": missed,
                                    "limit": limits["iterations"]}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in run.checks.values())
    return correct, attempted, failed


def conservation(run, lap=None):
    """tr(X^2), tr(X^3) of each component (MHD: tr(W Theta) too) and the
    flow's energy
    -<W, P>/2 (P = Delta^-1 W, <A, B> = Re sum A conj(B) / N), in float64,
    of member 0 at the window's first and last output, and their drift
    relative to the first.  A record, not a metric."""
    import torch

    lap = lap or Laplacian(run.N, run.program_device)
    names = ("W", "Theta")
    first, last = (_as_members(x, run)[0]
                   for x in (run.recorder.first, run.recorder.last))
    record = {"steps": run.window_steps - run.recorder.steps[0]}
    for tag, state in (("first", first), ("last", last)):
        values = {}
        for c in range(run.components):
            X = state[c]
            XX = X @ X
            values[f"tr_{names[c]}2"] = float(np.sum(X * X.T).real)
            values[f"tr_{names[c]}3"] = float(np.sum(XX * X.T).imag)
        if run.components == 2:  # cross helicity, a Casimir of MHD
            values["tr_WTheta"] = float(np.sum(state[0] * state[1].T).real)
        W = torch.from_numpy(state[0]).to(run.program_device)
        P = lap.solve(W)
        values["energy"] = float(-(W * P.conj()).sum().real / run.N / 2.0)
        record[tag] = values
    record["drift"] = {k: (record["last"][k] - v) / abs(v)
                       for k, v in record["first"].items() if v}
    return record
