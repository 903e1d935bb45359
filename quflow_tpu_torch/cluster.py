"""Job orchestration: launch, monitor, and retrieve long simulations.

Counterpart of quflow_tpu/cluster.py (the reference's quflow/cluster.py
workflow: a runfile and a Slurm submit script, rsync to a login node,
sbatch, a progress file polled over ssh, rsync back; reference
cluster.py:105-152, 173-418, 432-555), with the same API
(``solve``/``status``/``jobstatus``/``retrieve``/``delete``) and two
backends: **local** (a detached background process on this machine, the
common case on a host with its card) and **slurm** (ssh + rsync +
sbatch).  The job is the port's runfile (sim/runfile.py), which steps
with ``IsompTorch`` on the device that ``solve(device=...)`` names, the
CUDA device by default; it never picks the CPU by itself.  Job metadata
lives in a JSON sidecar (<sim>_cluster.json).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from .sim.runfile import create_runfile

__all__ = [
    "solve",
    "status",
    "jobstatus",
    "retrieve",
    "delete",
    "get_auto_cores",
    "get_simname",
]

_SUBMIT_TEMPLATE = """#!/usr/bin/env bash
#SBATCH -A {account}
#SBATCH -p {partition}
#SBATCH -N 1
#SBATCH -n {cores}
#SBATCH -t {walltime}
#SBATCH -J {simname}
{constraint}
python {runfile} -s{device}
"""


def get_simname(filename):
    return os.path.basename(str(filename)).replace(".hdf5", "").replace(".h5", "")


def _sidecar(filename):
    base = str(filename).replace(".hdf5", "").replace(".h5", "")
    return base + "_cluster.json"


def _progressfile(filename):
    return get_simname(filename) + "_progress.txt"


def get_auto_cores(N):
    """Recommended host core count by problem size (reference
    cluster.py:155-166 / notebook cell 19)."""
    if N <= 256:
        return 4
    if N <= 512:
        return 8
    if N <= 1024:
        return 16
    return 32


def _load_meta(filename):
    path = _sidecar(filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No job metadata at {path}; was solve() called?")
    with open(path) as f:
        return json.load(f)


def _save_meta(filename, meta):
    with open(_sidecar(filename), "w") as f:
        json.dump(meta, f, indent=2)


def _device_args(device):
    """The runfile's ``--device`` arguments: none for the default (the
    CUDA device)."""
    return [] if device is None else ["--device", str(device)]


def solve(
    filename,
    backend="local",
    server=None,
    account=None,
    partition="main",
    walltime="4-00:00:00",
    cores=None,
    arch=None,
    remote_dir="simulations",
    env=None,
    *,
    device=None,
    **solve_kwargs,
):
    """Launch a simulation job for the HDF5 file ``filename``.

    backend='local': run the generated runfile as a detached background
    process on this machine.  backend='slurm': rsync the simulation and
    runfile to ``server`` and submit with sbatch (requires ssh/rsync).
    ``device`` is the job's torch device (the runfile's ``--device``; by
    default the CUDA device, and a job without one fails).  Scalar
    ``solve_kwargs`` are stored in the simulation file, which the job's
    ``solve`` reads.  Returns the job id (pid for local, Slurm id for
    slurm).
    """
    filename = str(filename)
    simname = get_simname(filename)
    try:
        old = _load_meta(filename)
    except FileNotFoundError:
        old = None
    if old is not None and status(filename, verbatim=False).get("running"):
        raise RuntimeError(
            f"Job for {simname} appears to be running; delete() it first."
        )

    if solve_kwargs:
        from .sim import QuSimulation

        sim = QuSimulation(filename)
        for k, v in solve_kwargs.items():
            if np.isscalar(v) or isinstance(v, str):
                sim[k] = v

    runfile = create_runfile(filename)

    if backend == "local":
        logfile = os.path.join(
            os.path.dirname(filename) or ".", simname + "_job.log"
        )
        job_env = dict(os.environ)
        if env:
            job_env.update(env)
        with open(logfile, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, runfile, "-s", "-f", filename,
                 *_device_args(device)],
                stdout=log,
                stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(filename)),
                start_new_session=True,
                env=job_env,
            )
        meta = {
            "backend": "local",
            "jobid": proc.pid,
            "runfile": runfile,
            "logfile": logfile,
            "filename": os.path.abspath(filename),
            "device": device,
        }
        _save_meta(filename, meta)
        return proc.pid

    if backend == "slurm":
        if server is None:
            raise ValueError("backend='slurm' requires server=<ssh host>")
        if cores is None:
            from .sim import QuSimulation

            cores = get_auto_cores(int(QuSimulation(filename)["N"]))
        submitfile = os.path.join(
            os.path.dirname(filename) or ".", "submit_" + simname + ".sh"
        )
        with open(submitfile, "w") as f:
            f.write(
                _SUBMIT_TEMPLATE.format(
                    account=account or "unset",
                    partition=partition,
                    cores=cores,
                    walltime=walltime,
                    simname=simname,
                    constraint=f"#SBATCH -C {arch}" if arch else "",
                    runfile=os.path.basename(runfile),
                    device="".join(" " + a for a in _device_args(device)),
                )
            )
        rdir = f"{remote_dir}/{simname}"
        subprocess.run(["ssh", server, f"mkdir -p {rdir}"], check=True)
        subprocess.run(
            ["rsync", "-au", filename, runfile, submitfile, f"{server}:{rdir}/"],
            check=True,
        )
        out = subprocess.run(
            ["ssh", server,
             f"cd {rdir} && rm -f *_progress.txt && sbatch {os.path.basename(submitfile)}"],
            check=True, capture_output=True, text=True,
        ).stdout
        jobid = int(out.strip().split()[-1])
        meta = {
            "backend": "slurm",
            "jobid": jobid,
            "server": server,
            "remote_dir": rdir,
            "runfile": runfile,
            "filename": os.path.abspath(filename),
            "device": device,
        }
        _save_meta(filename, meta)
        return jobid

    raise ValueError(f"Unknown backend '{backend}'")


def _local_running(pid):
    """Whether process ``pid`` lives and is not a zombie (exited but not
    yet reaped because its launcher still lives)."""
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def status(filename, verbatim=True):
    """Check job liveness and last progress line."""
    meta = _load_meta(filename)
    info = {"running": False, "progress": None, "jobid": meta["jobid"]}
    if meta["backend"] == "local":
        info["running"] = _local_running(meta["jobid"])
        pf = os.path.join(
            os.path.dirname(meta["filename"]), _progressfile(meta["filename"])
        )
        if os.path.exists(pf):
            with open(pf) as f:
                lines = f.read().strip().splitlines()
            info["progress"] = lines[-1] if lines else None
    else:
        q = subprocess.run(
            ["ssh", meta["server"], f"squeue -j {meta['jobid']} -h"],
            capture_output=True, text=True,
        )
        info["running"] = bool(q.stdout.strip())
        p = subprocess.run(
            ["ssh", meta["server"],
             f"tail -1 {meta['remote_dir']}/{_progressfile(meta['filename'])}"],
            capture_output=True, text=True,
        )
        info["progress"] = p.stdout.strip() or None
    if verbatim:
        state = "RUNNING" if info["running"] else "NOT RUNNING"
        print(f"Job {info['jobid']}: {state}")
        if info["progress"]:
            print(info["progress"])
    return info


def jobstatus(server=None, verbatim=True):
    """List queued/running jobs (slurm backend: squeue; local: ps)."""
    if server is None:
        out = subprocess.run(
            ["ps", "-eo", "pid,etime,cmd"], capture_output=True, text=True
        ).stdout
        out = "\n".join(l for l in out.splitlines() if "_runfile.py" in l)
    else:
        out = subprocess.run(
            ["ssh", server, "squeue --me"], capture_output=True, text=True
        ).stdout
    if verbatim:
        print(out)
    return out


def retrieve(filename, onlyanim=False, onlysim=False):
    """Fetch results back (slurm backend); local backend is a no-op."""
    meta = _load_meta(filename)
    if meta["backend"] == "local":
        return meta["filename"]
    patterns = []
    if not onlyanim:
        patterns.append(os.path.basename(meta["filename"]))
    if not onlysim:
        patterns.append(get_simname(meta["filename"]) + ".mp4")
    dest = os.path.dirname(meta["filename"]) or "."
    for pat in patterns:
        subprocess.run(
            ["rsync", "-au", f"{meta['server']}:{meta['remote_dir']}/{pat}", dest],
            check=False,
        )
    return meta["filename"]


def delete(filename, remote=True, local=False):
    """Stop the job (and with ``local`` remove its sidecar)."""
    meta = _load_meta(filename)
    if meta["backend"] == "local":
        try:
            os.kill(meta["jobid"], 15)
        except OSError:
            pass
    elif remote:
        subprocess.run(
            ["ssh", meta["server"], f"scancel {meta['jobid']}"], check=False
        )
        subprocess.run(
            ["ssh", meta["server"], f"rm -rf {meta['remote_dir']}"], check=False
        )
    if local:
        path = _sidecar(filename)
        if os.path.exists(path):
            os.remove(path)
