"""Multi-process bring-up and checkpoints.

Counterpart of quflow_tpu/parallel/distributed.py on torch.distributed:

* :func:`initialize` brings up the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
  ``LOCAL_RANK``) or from its arguments: NCCL for card tensors (each
  process on the card of its ``LOCAL_RANK``), gloo on the CPU;
* :func:`global_mesh` builds the (dp, tp) mesh over every rank, the
  ensemble axis over all of them by default;
* :func:`save_checkpoint`/:func:`load_checkpoint` keep in-flight state.
  On one rank the file is ``step_{step}.npz`` with ``arr_0, arr_1, ...``,
  quflow_tpu's single-host fallback, so a checkpoint written by either
  package loads in the other (quflow_tpu's split planes come over through
  parallel.stepper.state_from_planes).  On several ranks each rank writes
  its own piece, ``step_{step}/rank_{r}.npz``, beside a manifest that
  names the mesh; loading on another mesh raises.  Nothing writes a
  rank's piece as if it were the global state: on several ranks without
  a mesh, saving raises, as quflow_tpu raises without orbax.

The portable archive stays the HDF5 simulation file (sim.QuSimulation).

NCCL and the captured reduce.  An adaptive step on an NCCL dp mesh is one
CUDA graph launch whose WHILE node holds the all_reduce of the residual's
key (parallel/capture.Loop).  Under NCCL's default, a collective captured
on a group of more than one rank carries an event record and an event
wait node, which order it against NCCL's work outside graphs; a WHILE
body refuses an event wait node, and the composite is not built
(``cudaGraphInstantiateWithParams``: cudaErrorInvalidValue at an event
wait node).  ``NCCL_GRAPH_MIXING_SUPPORT=0`` captures the collective
without them.  So :func:`initialize`, when it brings an NCCL group up,
sets ``NCCL_GRAPH_MIXING_SUPPORT=0`` first, unless the variable is
already set, in which case the user's value stands.  NCCL keeps its
results correct under that setting on two conditions, on each
communicator:

1. no parallel graph launches: no two launched graphs that hold its work
   outstanding at once on streams that do not order them;
2. no outstanding graph launch followed by a launch outside any graph,
   whatever the streams' dependencies.

The port meets both.  Its composites launch in order, on the caller's
stream, from the one thread that steps the state; and a call of an
adaptive runner reads the loop's counts once after its launches (the
call's one host read, on that stream), which ends every launch before
the call returns, so any collective outside a graph (``Mesh.max``,
``gather_state``, :func:`save_checkpoint`'s barrier, a user's callback)
comes after the graph's work has ended.  Where the setting is not in
force on a group of several ranks (a group that other code brought up,
or a user's ``NCCL_GRAPH_MIXING_SUPPORT=1``), :func:`holds_captured_reduce`
says so before any build, and the adaptive runner takes the host loop
(parallel.stepper._loop_mode: a warning, and the counter
``loop_mode.host`` of tracing.counters()).  NCCL reads the variable once
a process, at its first communicator: a value set later does not count.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .mesh import make_mesh

__all__ = ["initialize", "global_mesh", "save_checkpoint", "load_checkpoint",
           "holds_captured_reduce", "GRAPH_MIXING"]

#: NCCL's switch for graphs beside work outside graphs (see the module's
#: note); the port needs it "0" to capture a reduce inside a WHILE node
GRAPH_MIXING = "NCCL_GRAPH_MIXING_SUPPORT"


def initialize(init_method=None, world_size=None, rank=None, backend=None):
    """Bring up torch.distributed; returns whether a process group is up.
    With no arguments and no ``WORLD_SIZE`` in the environment (a single
    process started without torchrun) it does nothing and returns False.
    ``backend`` defaults to 'nccl' when a card is present and 'gloo'
    otherwise; under NCCL each process takes the card of its
    ``LOCAL_RANK`` (or of its rank), and ``NCCL_GRAPH_MIXING_SUPPORT`` is
    set to "0" where the environment does not set it (the module's
    note)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and world_size is None and "WORLD_SIZE" not in env:
        return False
    world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        env.setdefault(GRAPH_MIXING, "0")
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def holds_captured_reduce(size):
    """Whether a collective over an NCCL group of ``size`` ranks can be
    captured inside a WHILE node: one rank's holds no event node, and more
    ranks' need ``NCCL_GRAPH_MIXING_SUPPORT=0`` in this process's
    environment (the module's note)."""
    return size == 1 or os.environ.get(GRAPH_MIXING) == "0"


def global_mesh(dp=None):
    """The (dp, tp) mesh over every rank of the world group; ``dp``
    defaults to the world size (every rank steps its own ensemble
    members, tp = 1)."""
    import torch.distributed as dist

    if dp is None:
        dp = dist.get_world_size()
    return make_mesh(dp=dp)


def _flatten(tree):
    """Leaves of a tuple/list/dict tree in quflow_tpu's (jax.tree) order:
    sequences in order, dicts by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(path, state, step=0, mesh=None):
    """Save ``state`` (a tensor or array, or a tuple/list/dict tree of
    them) for ``step``; returns the path written.  One rank: the npz of
    quflow_tpu's single-host fallback.  Under a ``mesh`` of several ranks:
    this rank's piece and the manifest (collective: every rank calls it).
    On several ranks without a mesh it raises."""
    import torch.distributed as dist

    leaves = [_host(x) for x in _flatten(state)]
    if mesh is None or mesh.size == 1:
        world = dist.get_world_size() if (
            dist.is_available() and dist.is_initialized()) else 1
        if world > 1:
            raise RuntimeError(
                f"save_checkpoint on {world} ranks needs the mesh: a single "
                "npz would hold one rank's piece, not the global state")
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, f"step_{step}.npz")
        np.savez(out, *leaves)
        return out
    d = os.path.join(path, f"step_{step}")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, f"rank_{mesh.rank}.npz"), *leaves)
    if mesh.rank == 0:
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump({"dp": mesh.dp, "tp": mesh.tp,
                       "shapes": [list(x.shape) for x in leaves]}, f)
    dist.barrier(group=mesh.group)
    return d


def _like(a, x):
    if isinstance(x, torch.Tensor):
        return torch.from_numpy(a).to(device=x.device, dtype=x.dtype)
    return a


def load_checkpoint(path, like, step=0, mesh=None):
    """Load the checkpoint of ``step`` saved by :func:`save_checkpoint` (or
    by quflow_tpu's npz fallback); ``like`` is a tree of the same structure
    whose tensors fix each leaf's dtype and device (numpy leaves stay
    numpy).  A per-rank checkpoint loads only under a mesh of the shape
    its manifest names, each rank its own piece."""
    flat_like = _flatten(like)
    d = os.path.join(path, f"step_{step}")
    if os.path.isdir(d):
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        if mesh is None or (mesh.dp, mesh.tp) != (man["dp"], man["tp"]):
            have = None if mesh is None else (mesh.dp, mesh.tp)
            raise ValueError(
                f"checkpoint {d} was written on a mesh of (dp, tp) = "
                f"({man['dp']}, {man['tp']}); cannot load it on {have}")
        src = os.path.join(d, f"rank_{mesh.rank}.npz")
    else:
        src = os.path.join(path, f"step_{step}.npz")
        if not os.path.exists(src):
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{path}")
        if mesh is not None and mesh.size > 1:
            raise ValueError(
                f"{src} holds a single-rank state; load it on one rank and "
                "cut it with parallel.mesh.shard_state")
    with np.load(src) as data:
        if len(data.files) != len(flat_like):
            raise ValueError(f"{src} holds {len(data.files)} arrays; the "
                             f"structure of like has {len(flat_like)}")
        arrs = [data[f"arr_{i}"] for i in range(len(flat_like))]
    for a, x in zip(arrs, flat_like):
        if tuple(a.shape) != tuple(np.shape(x)):
            raise ValueError(f"{src}: an array of shape {a.shape} where "
                             f"like has {tuple(np.shape(x))}")
    return _unflatten(like, [_like(a, x) for a, x in zip(arrs, flat_like)])
