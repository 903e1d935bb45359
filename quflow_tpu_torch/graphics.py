"""Visualization: sphere plots, animations, matrix spy.

Counterpart of quflow_tpu/graphics.py (API parity with reference
quflow/graphics.py: ``resample`` :90-121, ``plot`` :124-343,
``Animation``/``create_animation`` :349-688, ``spy`` :691-720).  Every
function takes numpy arrays or tensors; a tensor is moved to the host once
(``_host``).  matplotlib is imported at first use, so that
``import quflow_tpu_torch`` does not need it (the CUDA card's host has
none); cartopy (orthographic/perspective projections) and ffmpeg are
optional.  Animations use matplotlib.animation writers (ffmpeg when
present, else Pillow).
"""

from __future__ import annotations

import numpy as np
import torch

from .quantization import mat2shr
from .transforms import as_fun

__all__ = [
    "resample",
    "plot",
    "plot2",
    "spy",
    "Animation",
    "create_animation",
    "create_animation2",
    "adjust_colormap_brightness",
]


def _pyplot():
    """matplotlib.pyplot on a non-interactive backend unless one is set;
    ImportError names what is missing."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("quflow_tpu_torch.graphics needs matplotlib") from exc
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(data):
    """A tensor -> numpy on the host (one copy); anything else as numpy."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _real_fun(data):
    fun = as_fun(data)
    return fun.real if np.iscomplexobj(fun) else fun


def adjust_colormap_brightness(cmap_name, r, N=None):
    """A ListedColormap with brightness scaled by r (>1 brighter, <1
    darker); parity with reference graphics.py:31-87."""
    _pyplot()
    import matplotlib
    from matplotlib.colors import ListedColormap

    cmap = matplotlib.colormaps[cmap_name]
    if N:
        cmap = cmap.resampled(N)
    colors = cmap(np.linspace(0, 1, cmap.N))
    if r >= 1.0:
        colors[:, :3] = 1.0 - (1.0 - colors[:, :3]) / r
    else:
        colors[:, :3] = colors[:, :3] * r
    return ListedColormap(np.clip(colors, 0, 1))


def resample(data, N):
    """Up-/downsample any representation to resolution N: coefficient
    truncation/zero-padding for mat/shr data, bilinear interpolation for
    grid functions.  A grid already at N comes back as it is."""
    if not isinstance(data, np.ndarray):
        data = _host(data)
    if data.ndim == 2:
        if np.iscomplexobj(data) and data.shape[0] == data.shape[1]:
            omega = mat2shr(data)
        elif np.isrealobj(data) and 2 * data.shape[0] - 1 == data.shape[1]:
            if data.shape[0] == N:
                return data
            from scipy.ndimage import map_coordinates

            X, Y = np.meshgrid(
                np.linspace(0, data.shape[0] - 1, N, endpoint=True),
                np.linspace(0, data.shape[1], 2 * N - 1, endpoint=False),
                indexing="ij",
            )
            return map_coordinates(data, np.array([X, Y]), order=1,
                                   mode="reflect")
        else:
            raise NotImplementedError("Resampling this data is not supported yet.")
    elif data.ndim == 1:
        omega = data
    else:
        raise NotImplementedError("Resampling this data is not supported yet.")
    omega2 = np.zeros(N**2, dtype=omega.dtype)
    n = min(N**2, omega.shape[0])
    omega2[:n] = omega[:n]
    return omega2


def _cartopy_projection(projection, central_latitude, central_longitude):
    """The cartopy CRS of 'orthographic'/'perspective' (ImportError without
    cartopy), a CRS passed in as it is, or None for a matplotlib one."""
    if projection in ("orthographic", "perspective"):
        try:
            import cartopy.crs as ccrs
        except ImportError as exc:
            raise ImportError(f"projection='{projection}' requires cartopy "
                              "(not installed)") from exc
        cls = (ccrs.Orthographic if projection == "orthographic"
               else ccrs.NearsidePerspective)
        return cls(central_latitude=central_latitude,
                   central_longitude=central_longitude)
    if projection is None or isinstance(projection, str):
        return None
    return projection  # a cartopy CRS given by the caller


def plot(
    data,
    fig=None,
    ax=None,
    dpi=None,
    colorbar=False,
    title=None,
    padding=None,
    N=None,
    time=None,
    projection="hammer",
    central_latitude=20,
    central_longitude=30,
    annotate=None,
    grid=True,
    grid_kwargs=None,
    contours=None,
    contour_data=None,
    contour_kwargs=None,
    **kwargs,
):
    """Plot a state (mat | shr | shc | fun, numpy or tensor) on the sphere.

    ``projection``: 'hammer' or 'mollweide' (matplotlib), 'orthographic' or
    'perspective' (cartopy, if installed), or None for raw theta-phi axes.
    Returns the QuadMesh from pcolormesh.
    """
    plt = _pyplot()
    data = _host(data)
    if N is not None:
        data = resample(data, N)
    fun = _real_fun(data)
    crs = _cartopy_projection(projection, central_latitude, central_longitude)

    if ax is None:
        if fig is None:
            figsize = plt.rcParams.get("figure.figsize")
            fig = plt.figure(
                figsize=(figsize[0], figsize[0] * fun.shape[0] / fun.shape[1]),
                dpi=dpi,
            )
        if crs is not None:
            ax = fig.add_subplot(projection=crs)
        elif projection in ("hammer", "mollweide"):
            ax = fig.add_subplot(projection=projection)
        else:
            ax = fig.add_subplot()
        if title:
            ax.set_title(title)

    minmax = np.abs(fun).max()
    kwargs.setdefault("vmin", -minmax)
    kwargs.setdefault("vmax", minmax)
    kwargs.setdefault("cmap", "RdBu_r")

    lon = np.linspace(-np.pi, np.pi, fun.shape[1], endpoint=False)
    lat = np.linspace(-np.pi / 2.0, np.pi / 2.0, fun.shape[0])
    # plot north pole up: theta ascends from the pole, latitude descends
    fun_plot = fun[::-1, :]

    grid_kwargs = {**{"color": "black", "alpha": 0.2}, **(grid_kwargs or {})}
    if crs is not None:
        import cartopy.crs as ccrs

        lon = lon * 180 / np.pi
        lat = lat * 180 / np.pi
        kwargs.setdefault("transform", ccrs.PlateCarree())
    im = ax.pcolormesh(lon, lat, fun_plot, rasterized=True, **kwargs)

    if grid:
        if crs is not None:
            ax.gridlines(draw_labels=False, dms=True, **grid_kwargs)
        else:
            ax.grid(linestyle="-", **grid_kwargs)
    ax.set_xticklabels([])
    ax.set_yticklabels([])

    if time is not None:
        ax.text(
            0.05, 0.95, f"time: {time:.2f}", transform=ax.transAxes,
            verticalalignment="top",
        )
    if colorbar:
        im.figure.colorbar(mappable=im, ax=ax)
    if annotate is not None:
        ax.set_autoscale_on(False)
        xlim, ylim = ax.get_xlim(), ax.get_ylim()
        annotate(ax)
        ax.set_xlim(xlim)
        ax.set_ylim(ylim)

    if isinstance(contours, bool) and not contours:
        contours = None
    if contours is not None:
        if contour_data is None:
            contour_fun = fun_plot
        else:
            contour_data = _host(contour_data)
            if N is not None:
                contour_data = resample(contour_data, N)
            contour_fun = _real_fun(contour_data)[::-1, :]
        ckw = {
            "negative_linestyles": "solid",
            "colors": None if contour_kwargs and "cmap" in contour_kwargs else "k",
            "linewidths": 0.5,
            "vmin": kwargs["vmin"],
            "vmax": kwargs["vmax"],
            "levels": 10 if isinstance(contours, bool) else contours,
        }
        if crs is not None:
            ckw["transform"] = kwargs["transform"]
        ckw.update(contour_kwargs or {})
        ax.contour(lon, lat, contour_fun, **ckw)
    return im


plot2 = plot  # reference alias (quflow/graphics.py:346)


def spy(W, colorbar=True, logscale=True, ax=None):
    """Visualize a complex matrix (numpy or tensor): |W| with optional log
    scale."""
    plt = _pyplot()
    mag = np.abs(_host(W))
    if logscale:
        mag = np.log10(mag + 1e-300)
    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(mag, cmap="viridis")
    if colorbar:
        im.figure.colorbar(im, ax=ax)
    return im


class Animation:
    """Streaming animation writer (context manager).

    with Animation("out.mp4", fps=25) as anim:
        for W in states:
            anim.add_frame(W)
    """

    def __init__(self, filename, fps=25, dpi=100, preset="medium",
                 extra_args=None, codec=None, plot_kwargs=None):
        self._plt = _pyplot()
        self.filename = str(filename)
        self.fps = fps
        self.dpi = dpi
        self.plot_kwargs = plot_kwargs or {}
        self._writer = None
        self._fig = None
        self._im = None

    def __enter__(self):
        return self

    def _init_writer(self, fun):
        from matplotlib import animation as manim

        self._fig = self._plt.figure(
            figsize=(fun.shape[1] / self.dpi, fun.shape[0] / self.dpi),
            dpi=self.dpi,
        )
        ax = self._fig.add_axes([0, 0, 1, 1])
        ax.set_axis_off()
        vmax = np.abs(fun).max()
        self._im = ax.imshow(
            fun[::-1, :], cmap=self.plot_kwargs.get("cmap", "RdBu_r"),
            vmin=self.plot_kwargs.get("vmin", -vmax),
            vmax=self.plot_kwargs.get("vmax", vmax),
        )
        if manim.FFMpegWriter.isAvailable() and self.filename.endswith(".mp4"):
            self._writer = manim.FFMpegWriter(fps=self.fps)
        else:
            if self.filename.endswith(".mp4"):
                self.filename = self.filename[:-4] + ".gif"
            self._writer = manim.PillowWriter(fps=self.fps)
        self._writer.setup(self._fig, self.filename, dpi=self.dpi)

    def add_frame(self, data):
        fun = _real_fun(_host(data))
        if self._writer is None:
            self._init_writer(fun)
        self._im.set_data(fun[::-1, :])
        self._writer.grab_frame()

    def close(self):
        if self._writer is not None:
            self._writer.finish()
            self._plt.close(self._fig)
            self._writer = None

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()
        return False


def create_animation(
    filename, states, N=None, fps=25, preset="medium", extra_args=None,
    codec=None, progress_bar=True, progress_file=None, **kwargs
):
    """Render a sequence of states (a list, an array or a tensor whose
    first axis runs over them) to a video/gif file; returns its name."""
    if isinstance(states, torch.Tensor):
        states = _host(states)
    pbar = None
    opened = None
    if progress_bar:
        try:
            from tqdm.auto import tqdm
        except ModuleNotFoundError:
            tqdm = None
        if tqdm is not None:
            if isinstance(progress_file, str):
                progress_file = opened = open(progress_file, "w")
            pbar = tqdm(
                total=len(states), unit=" frames", file=progress_file,
                ascii=progress_file is not None, mininterval=1.0,
            )
    try:
        with Animation(filename, fps=fps, plot_kwargs=kwargs) as anim:
            for state in states:
                if N is not None:
                    state = resample(_host(state), N)
                anim.add_frame(state)
                if pbar is not None:
                    pbar.update(1)
    finally:
        if pbar is not None:
            pbar.close()
        if opened is not None:
            opened.close()
    return anim.filename


create_animation2 = create_animation
