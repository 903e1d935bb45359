"""The end of each pass of the device loop (``loop_pass`` in
csrc/graph_loop.cu: the residual, dW written back and the exit rule in one
kernel) on one CUDA card, against the sequence it replaced and against
another build of graph_loop.cu.

    python3 benchmarks/torch_loop_pass.py [--against OTHER.cu]
        [--phases time,steps] [--out FILE.jsonl]

Phases, each printed as JSON lines (and, with ``--out``, written there):

- ``time``: ``loop_pass`` at each shape of chip_smoke.LOOP_PASS_TIMES
  (the adaptive runs' shapes of phase 24b, N in {256, 512, 1024} in both
  dtypes, B=16) by CUDA-graph replay, in turns with the sequence it
  replaced (the residual in torch, the copies of rn, dW and the rest, and
  ``loop_decide``; with ``--against``, the other build's ``loop_decide``),
  beside its bound, the library's residual and copy and the plain
  version's time (chip_smoke.loop_pass_times);
- ``steps``: the steps/s of phase 24b's six runs (chip_smoke.loop_cases)
  through the device loop, in turns (other, this, this, other): with
  ``--against`` the other build's device loop, whose WHILE body ends on
  its ``loop_decide`` after the iteration took the residual in torch and
  copied rn, dW and the rest (:class:`OtherLoop`), against this build's;
  without it, the host loop (``config.eager()``) against this build's
  device loop.  Each turn's host ms a step and its CUDA-event span; the
  iterations and the final states compared.

``--against`` builds another source of graph_loop.cu (say a parent
commit's, from ``git show``) whose ``graph_loop_build`` takes the
iteration's residual and the state, ``(head, warm, iteration, tail, rn,
state, capacity, f64, device, stream, out)``, and whose ``loop_decide_f32``
and ``loop_decide_f64`` take ``(rn, state, capacity, stream)``.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import weakref
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from quflow_tpu_torch.integrators import isospectral  # noqa: E402
from quflow_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    cuda_graph_loop,
    cuda_scan_solve,
    cuda_solve,
)
from quflow_tpu_torch.parallel import capture  # noqa: E402
from torch_row_solve import build  # noqa: E402  (this directory)


def bind_other(lib):
    """Declare the other build's C entries (pointers and the stream as
    c_void_p, counts and flags as c_int)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.loop_decide_f32, lib.loop_decide_f64):
        fn.argtypes, fn.restype = [P, P, I, P], I
    lib.graph_loop_build.argtypes = [P] * 6 + [I] * 3 + [P,
                                                          ctypes.POINTER(P)]
    lib.graph_loop_build.restype = I
    lib.graph_loop_launch.argtypes, lib.graph_loop_launch.restype = \
        [P, I, P], I
    lib.graph_loop_destroy.argtypes, lib.graph_loop_destroy.restype = \
        [P], None
    lib.graph_loop_message.argtypes = []
    lib.graph_loop_message.restype = ctypes.c_char_p
    return lib


def other_decide(lib):
    """``loop_decide(rn, state)`` on the other build, one launch."""
    def decide(rn, state):
        fn = lib.loop_decide_f64 if rn.dtype == torch.float64 else \
            lib.loop_decide_f32
        err = fn(rn.data_ptr(), state.data_ptr(),
                 state.numel() - cuda_graph_loop.HEADER,
                 torch.cuda.current_stream(state.device).cuda_stream)
        if err:
            raise RuntimeError(f"the other loop_decide: cudaError_t {err}")
        return state[cuda_graph_loop.CONTINUE]
    return decide


class OtherComposite:
    """The other build's composite: head, warm, WHILE {iteration ->
    loop_decide on rn}, tail."""

    def __init__(self, lib, head, warm, iteration, tail, rn, state):
        out = ctypes.c_void_p()
        device = state.device
        err = lib.graph_loop_build(
            head or None, warm or None, iteration, tail, rn.data_ptr(),
            state.data_ptr(), state.numel() - cuda_graph_loop.HEADER,
            int(rn.dtype == torch.float64), device.index or 0,
            torch.cuda.current_stream(device).cuda_stream, ctypes.byref(out))
        if err:
            raise RuntimeError(f"the other composite: "
                               f"{lib.graph_loop_message().decode()}")
        self.device, self._lib, self._handle = device, lib, out.value
        self._finalizer = weakref.finalize(self, lib.graph_loop_destroy,
                                           out.value)

    def launch(self, steps=1):
        err = self._lib.graph_loop_launch(
            self._handle, int(steps),
            torch.cuda.current_stream(self.device).cuda_stream)
        if err:
            raise RuntimeError(f"the other composite's launch: "
                               f"{self._lib.graph_loop_message().decode()}")

    def close(self):
        self._finalizer()


class OtherLoop(capture.Loop):
    """parallel.capture.Loop on the other build: the captured iteration
    also takes the residual in torch (max over rows of sum |dW_new - dW|)
    into a static rn and copies dW_new into dW and each rest into a static
    buffer, which the tail reads; the WHILE body ends on the other build's
    ``loop_decide``.  ``lib`` is set before use."""

    lib = None

    def __init__(self, graphs, iterate, W, dW, tail, head=None, warm=None,
                 capacity=0):
        self.W, self.dW = W, dW
        self.rest = self.rn = None

        def body():
            dW_new, *rest = iterate(self.W, self.dW)
            rn = (dW_new - self.dW).abs().sum(-1).max()
            if self.rn is None:  # at the warm-up, outside the capture
                self.rn = torch.empty_like(rn)
                self.rest = [None if r is None else capture.static_copy(r)
                             for r in rest]
            self.rn.copy_(rn)
            self.dW.copy_(dW_new)
            for buf, r in zip(self.rest, rest):
                if buf is not None:
                    buf.copy_(r)

        named = [(k, p) for k, p in (("head", head), ("warm", warm),
                                     ("body", body),
                                     ("tail", lambda: tail(self.rest)))
                 if p is not None]
        self.state = cuda_graph_loop.new_state(W.device, capacity)
        self.capacity = capacity
        self._launched = 0
        self.pieces = dict(zip((k for k, _ in named), graphs.capture(
            *(p for _, p in named), keep=True)))
        raw = {k: g.graph.raw_cuda_graph() for k, g in self.pieces.items()}
        self.composite = OtherComposite(self.lib, raw.get("head"),
                                        raw.get("warm"), raw["body"],
                                        raw["tail"], self.rn, self.state)


@contextlib.contextmanager
def loops_of(cls, kept):
    """Adaptive runs built and run inside go through ``cls`` and keep
    isomp's and magmp's captured loops in ``kept``."""
    saved = capture.Loop, isospectral._LOOPS
    capture.Loop, isospectral._LOOPS = cls, kept
    try:
        yield
    finally:
        capture.Loop, isospectral._LOOPS = saved


def emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def timing(device, out, other):
    """Phase time: chip_smoke.loop_pass_times, its replaced sequence on the
    other build's loop_decide when there is one."""
    saved = chip_smoke.loop_decide
    if other is not None:
        chip_smoke.loop_decide = other_decide(other)
    try:
        rows = chip_smoke.loop_pass_times(device)
    finally:
        chip_smoke.loop_decide = saved
    for row in rows:
        emit(dict(phase="time", replaced_decide="other" if other else "this",
                  **row), out)


def steps(device, out, other):
    """Phase steps: each 24b run in turns (other, this, this, other)."""
    if other is not None:
        OtherLoop.lib = other
        modes = {"other": (OtherLoop, False), "this": (capture.Loop, False)}
    else:
        modes = {"other": (capture.Loop, True), "this": (capture.Loop, False)}
    for name, (make, n_steps, _, _) in chip_smoke.loop_cases(device).items():
        kept = {m: OrderedDict() for m in modes}
        runs = {}
        for m, (cls, eager) in modes.items():
            with loops_of(cls, kept[m]):
                runs[m] = make(eager)[1]
                runs[m]()  # builds and captures
        turns, spans, outs = {}, {}, {}
        for m in ("other", "this", "this", "other"):
            cls, eager = modes[m]
            with loops_of(cls, kept[m]):
                res, sec, span = chip_smoke.timed_turn(runs[m], device)
            turns.setdefault(m, []).append(1e3 * sec / n_steps)
            spans.setdefault(m, []).append(1e3 * span / n_steps)
            outs.setdefault(m, res)
        iters = {m: o[1] for m, o in outs.items()}
        same_iters = (torch.equal(iters["this"], iters["other"])
                      if isinstance(iters["this"], torch.Tensor)
                      else iters["this"] == iters["other"])
        med = {m: float(np.median(v)) for m, v in turns.items()}
        emit(dict(phase="steps", run=name,
                  other="another build's device loop" if other is not None
                  else "the host loop",
                  host_ms_a_step=turns, span_ms_a_step=spans,
                  steps_per_s={m: 1e3 / v for m, v in med.items()},
                  this_over_other=med["other"] / med["this"],
                  iterations_equal=bool(same_iters),
                  states_equal=bool(torch.equal(outs["this"][0],
                                                outs["other"][0]))), out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another build of csrc/graph_loop.cu whose "
                    "composite ends each pass on loop_decide")
    ap.add_argument("--phases", default="time,steps")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_loop_pass.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    cuda_build.build_all([cuda_graph_loop.LIBRARY, cuda_solve.LIBRARY,
                          cuda_scan_solve.LIBRARY])
    other = (bind_other(build("graph_loop_other", args.against.read_text()))
             if args.against else None)
    out = args.out.open("w") if args.out else None
    phases = args.phases.split(",")
    with torch.no_grad():
        if "time" in phases:
            timing(device, out, other)
        if "steps" in phases:
            steps(device, out, other)


if __name__ == "__main__":
    main()
