"""HDF5-backed simulation storage: the QuSimulation class.

Functional parity with reference quflow/simulation.py:49-478 - multiple
state representations ("qutypes": mat/shr/shc/fun/funL2/funhalf/funL2half),
resizable chunked datasets appended per output step, time/step series,
logger series, and solver configuration persisted as attrs - with one
deliberate change: callables are persisted *by registry name* (JSON), never
pickled, and stored 'prerun' code is not executed on load unless
``trusted=True`` (see quflow_tpu/sim/registry.py).

A copy of quflow_tpu/sim/simulation.py on the port's numpy transforms and
registry.  h5py is imported at first use, so that the package imports on a
host without it.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np

from ..quantization import mat2shr, mat2shc
from ..transforms import shr2fun, shc2fun
from . import registry

__all__ = ["QuSimulation"]


def _h5py():
    import h5py

    return h5py


_default_qutypes = {"mat": None, "fun": np.float32, "funL2": np.float32}
_default_qutype2varname = {
    "mat": "state",
    "shr": "shr",
    "shc": "shc",
    "fun": "fun",
    "funhalf": "fun",
    "funL2": "funL2",
    "funL2half": "funL2",
}
_callable_argnames = [
    "qutypes",
    "hamiltonian",
    "forcing",
    "integrator",
    "callback",
    "integrator_callback",
    "strang_splitting",
]
_info_args = ["prerun", "version", "created"]


def _dtype_to_str(dt):
    return None if dt is None else np.dtype(dt).str


def _dtype_from_str(s):
    return None if s is None else np.dtype(s)


class QuSimulation:
    """Simulation output on disk, usable as a ``solve`` callback.

    Read access: ``sim['mat', -1]``, ``sim['time']``, ``sim['step']``,
    ``sim['<logger>', i]``, plus stored solver args by name.
    Write access: ``sim[name] = value`` stores solver configuration
    (callables by registry name).
    """

    def __init__(
        self,
        filename,
        qutypes: dict = None,
        datapath: str = "/",
        overwrite: bool = False,
        loggers: dict = None,
        state: np.ndarray = None,
        time=None,
        trusted: bool = False,
        **kwargs,
    ):
        from .. import __version__

        self.filename = str(filename)
        if not datapath.endswith("/"):
            raise ValueError("Datapath must end with /")
        if not datapath.startswith("/"):
            datapath = "/" + datapath
        self.datapath = datapath
        self.fieldnames = {}
        self.loggers = loggers if loggers is not None else {}
        self.trusted = trusted
        self.args_datapath = self.datapath + "args/"

        if not os.path.exists(self.filename) or overwrite:
            if state is None:
                raise ValueError(
                    "At least `state` must be provided to initialize a QuSimulation."
                )
            self.qutypes = dict(qutypes) if qutypes is not None else dict(_default_qutypes)
            if "fun" in self.qutypes and "funhalf" in self.qutypes:
                raise ValueError("Cannot have both fun and funhalf outputs.")
            if "funL2" in self.qutypes and "funL2half" in self.qutypes:
                raise ValueError("Cannot have both funL2 and funL2half outputs.")

            with _h5py().File(self.filename, "w") as f:
                if self.datapath != "/":
                    f.create_group(self.datapath)
                g = f[self.datapath]
                g.attrs["version"] = __version__
                g.attrs["created"] = datetime.datetime.now().isoformat()
                g.attrs["qutypes"] = json.dumps(
                    {k: _dtype_to_str(v) for k, v in self.qutypes.items()}
                )
                logger_names = {
                    k: registry.name_of(v) or getattr(v, "__name__", str(v))
                    for k, v in self.loggers.items()
                }
                g.attrs["loggers"] = json.dumps(logger_names)
                f.create_group(self.args_datapath)
            self.initialize_field(W=state, time=time if time is not None else 0.0, **kwargs)
        else:
            with _h5py().File(self.filename, "r") as f:
                g = f[self.datapath]
                self.qutypes = {
                    k: _dtype_from_str(v)
                    for k, v in json.loads(g.attrs["qutypes"]).items()
                }
                if "N" in g.attrs and state is not None:
                    raise ValueError(
                        self.filename + " has already been initialized with W."
                    )
                if qutypes is not None:
                    raise ValueError(
                        self.filename + " has already been initialized with qutypes."
                    )
                if not self.loggers and "loggers" in g.attrs:
                    names = json.loads(g.attrs["loggers"])
                    # loggers are optional diagnostics: degrade gracefully
                    # (with a warning) instead of refusing to open the file
                    self.loggers = {
                        k: v
                        for k, nm in names.items()
                        if callable(v := registry.resolve(nm, default=None))
                    }
        self._update_fieldnames()

    # -- context manager (read) --------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        return False

    # -- attribute store ----------------------------------------------------
    def __setitem__(self, name, value):
        with _h5py().File(self.filename, "r+") as f:
            if name in _callable_argnames:
                if value is None:
                    f[self.args_datapath].attrs.pop(name, None)
                else:
                    nm = registry.name_of(value)
                    if nm is None:
                        nm = getattr(value, "__name__", None)
                        if nm is None:
                            raise ValueError(
                                f"Cannot persist callable for '{name}': register "
                                "it with quflow_tpu_torch.sim.registry.register()."
                            )
                    f[self.args_datapath].attrs[name] = "callable:" + nm
            elif name == "prerun":
                prerun = "\n".join(
                    l for l in value.strip().split("\n") if "In[len" not in l
                )
                f[self.datapath].attrs[name] = prerun
            elif name in _info_args:
                if value is None:
                    f[self.datapath].attrs.pop(name, None)
                else:
                    f[self.datapath].attrs[name] = value
            else:
                if value is None:
                    f[self.args_datapath].attrs.pop(name, None)
                else:
                    f[self.args_datapath].attrs[name] = value

    def _resolve_callable(self, name):
        fn = registry.resolve(name, default=None, warn=False)
        if fn is None and self.trusted:
            # fall back to prerun-defined names when explicitly trusted
            env: dict = {}
            prerun = self.prerun
            if prerun:
                exec(prerun, env)
                if name in env:
                    return env[name]
        if fn is None:
            registry.resolve(name)  # raises KeyError with a register() hint
        return fn

    @property
    def prerun(self):
        with _h5py().File(self.filename, "r") as f:
            return f[self.datapath].attrs.get("prerun", None)

    def __getitem__(self, name):
        ind = None
        if isinstance(name, tuple):
            if isinstance(name[0], str):
                ind = name[1:] if len(name) > 2 else name[1]
                name = name[0]
        if not isinstance(name, str):
            ind = name
            name = "mat"
        if name == "mat":
            name = _default_qutype2varname["mat"]
        with _h5py().File(self.filename, "r") as f:
            if self.datapath + name in f:
                ds = f[self.datapath + name]
                return ds[ind] if ind is not None else ds[:]
            if name in f[self.args_datapath].attrs:
                value = f[self.args_datapath].attrs[name]
                if isinstance(value, str) and value.startswith("callable:"):
                    return self._resolve_callable(value[len("callable:"):])
                return value
            if name in f[self.datapath].attrs:
                if name == "qutypes":
                    return {
                        k: _dtype_from_str(v)
                        for k, v in json.loads(f[self.datapath].attrs[name]).items()
                    }
                return f[self.datapath].attrs[name]
            raise KeyError(f"There is no dataset or attribute '{name}'.")

    def args(self):
        with _h5py().File(self.filename, "r") as f:
            names = list(f[self.args_datapath].attrs)
        for name in names:
            yield name, self[name]

    # -- representation pipeline -------------------------------------------
    def qutypes_iterator(self, W, qutype2varname=None):
        W = np.asarray(W)
        N = W.shape[-1]
        if qutype2varname is None:
            qutype2varname = _default_qutype2varname
        omegar = None
        omegac = None
        for qutype, dtype in self.qutypes.items():
            isreal = np.isrealobj(np.array([], dtype=dtype))
            if qutype == "mat":
                arr = W.astype(dtype if dtype is not None else W.dtype)
            elif qutype == "shr":
                if omegar is None:
                    omegar = np.squeeze(
                        np.array([mat2shr(Wi) for Wi in W.reshape((-1, N, N))])
                    )
                arr = omegar.astype(
                    dtype if dtype is not None else W.ravel()[:1].real.dtype
                )
            elif qutype == "shc":
                if omegac is None:
                    omegac = np.squeeze(
                        np.array([mat2shc(Wi) for Wi in W.reshape((-1, N, N))])
                    )
                arr = omegac.astype(dtype if dtype is not None else W.dtype)
            elif "fun" in qutype:
                if isreal:
                    if omegar is None:
                        omegar = np.squeeze(
                            np.array([mat2shr(Wi) for Wi in W.reshape((-1, N, N))])
                        )
                    omega = omegar
                    sh2fun = shr2fun
                else:
                    if omegac is None:
                        omegac = np.squeeze(
                            np.array([mat2shc(Wi) for Wi in W.reshape((-1, N, N))])
                        )
                    omega = omegac
                    sh2fun = shc2fun
                frames = []
                for omegai in omega.reshape((-1, omega.shape[-1])):
                    kwargs = {}
                    if "half" in qutype:
                        omegai = omegai[..., : (N // 2) ** 2]
                    if "funL2" in qutype:
                        kwargs["berezin"] = False
                    frames.append(sh2fun(omegai, **kwargs))
                arr = np.squeeze(np.array(frames, dtype=dtype))
            else:
                raise ValueError(f"Unknown qutype '{qutype}'.")
            yield qutype2varname[qutype], arr, qutype

    def _update_fieldnames(self):
        with _h5py().File(self.filename, "r") as f:
            for name in f[self.datapath].keys():
                ds = f[self.datapath + name]
                if isinstance(ds, _h5py().Dataset):
                    self.fieldnames[name] = (ds.shape, ds.dtype)

    # -- dataset lifecycle ---------------------------------------------------
    def initialize_field(self, W, time=0.0, **kwargs):
        with _h5py().File(self.filename, "r+") as f:
            if W is not None:
                W = np.asarray(W)
                N = W.shape[-1]
                for varname, arr, qutype in self.qutypes_iterator(W):
                    varset = f.create_dataset(
                        self.datapath + varname,
                        (1,) + arr.shape,
                        dtype=arr.dtype,
                        maxshape=(None,) + arr.shape,
                        chunks=(1,) + arr.shape,
                    )
                    varset[0, ...] = arr
                    varset.attrs["qutype"] = qutype
                f[self.datapath].attrs["N"] = N

            ts = f.create_dataset(
                self.datapath + "time", (1,), dtype=np.float64, maxshape=(None,)
            )
            ts[0] = time
            ss = f.create_dataset(
                self.datapath + "step", (1,), dtype=int, maxshape=(None,)
            )
            ss[0] = 0

            for name, logger in self.loggers.items():
                value = np.asarray(logger(W))
                varset = f.create_dataset(
                    self.datapath + name,
                    (1,) + value.shape,
                    dtype=value.dtype,
                    maxshape=(None,) + value.shape,
                )
                varset[0, ...] = value

            for name in ["tol_auto", "iterations", "number_of_maxit"]:
                kwargs.setdefault(name, 0.0)
            for name, value in kwargs.items():
                if name in ("time", "step"):
                    raise ValueError(f"{name} is not a valid field name.")
                arr = np.asarray(value)
                varset = f.create_dataset(
                    self.datapath + name,
                    (1,) + arr.shape,
                    dtype=arr.dtype,
                    maxshape=(None,) + arr.shape,
                )
                varset[0, ...] = arr
        self._update_fieldnames()

    def __call__(self, W, delta_time, delta_steps=1, **kwargs):
        """Append one output step."""
        with _h5py().File(self.filename, "r+") as f:
            for varname, arr, qutype in self.qutypes_iterator(W):
                varset = f[self.datapath + varname]
                varset.resize(varset.shape[0] + 1, axis=0)
                varset[-1, ...] = arr
            ts = f[self.datapath + "time"]
            ts.resize(ts.shape[0] + 1, axis=0)
            ts[-1] = ts[-2] + delta_time
            ss = f[self.datapath + "step"]
            ss.resize(ss.shape[0] + 1, axis=0)
            ss[-1] = ss[-2] + delta_steps
            for varname, value in kwargs.items():
                if self.datapath + varname in f and varname not in self.loggers:
                    varset = f[self.datapath + varname]
                    varset.resize(varset.shape[0] + 1, axis=0)
                    varset[-1, ...] = value
            for name, logger in self.loggers.items():
                varset = f[self.datapath + name]
                varset.resize(varset.shape[0] + 1, axis=0)
                varset[-1, ...] = np.asarray(logger(np.asarray(W)))
