"""Video slices (reference ``src/slices.f90``: ``wvid_prepare``/``wvid``,
``video.in`` lists fields, planes xy/xy2/xz/yz written at dvid cadence to
``data/proc*/slice_<field>.<plane>``).

JAX-native: per-plane time series appended into one ``.npz``-per-flush-free
npy stack via a simple growing list flushed by the Run driver; files are
``data/slice_<field>_<plane>.npz`` holding arrays ``t`` (nt,) and ``data``
(nt, n1, n2)."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .averages import QUANTS
from ..parallel.halo import fill_ghosts
from ..physics.pencils import Pencils

PLANES = {
    "xy": lambda a, iz: a[:, :, iz],
    "xy2": lambda a, iz: a[:, :, -max(iz, 1)],
    "xz": lambda a, iy: a[:, iy, :],
    "yz": lambda a, ix: a[ix, :, :],
}


class SliceWriter:
    def __init__(self, datadir, fields=("ux", "uz"), planes=("xy", "xz"),
                 index=None):
        self.datadir = str(datadir)
        self.fields = list(fields)
        self.planes = list(planes)
        self.index = index  # plane positions; default mid-box
        self._buf: Dict[str, List] = {}
        self._t: List[float] = []

    def capture(self, model, state):
        cfg, reg, grid, eos = model.cfg, model.reg, model.grid, model.eos
        fa = reg.stack(state["fields"])
        fg = fill_ghosts(fa[: reg.ncom], cfg.grid,
                         (cfg.bcx, cfg.bcy, cfg.bcz), reg, grid, cfg, eos)
        pen = Pencils(fg, grid, reg, cfg, eos)
        n = cfg.grid.shape
        self._t.append(float(np.asarray(state["t"])))
        for f in self.fields:
            arr = np.asarray(QUANTS[f](pen))
            for p in self.planes:
                mid = {"xy": n[2] // 2, "xy2": 1, "xz": n[1] // 2,
                       "yz": n[0] // 2}[p]
                idx = self.index or mid
                key = f"{f}_{p}"
                self._buf.setdefault(key, []).append(PLANES[p](arr, idx))

    def flush(self):
        os.makedirs(self.datadir, exist_ok=True)
        for key, frames in self._buf.items():
            path = os.path.join(self.datadir, f"slice_{key}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    t0, d0 = list(z["t"]), list(z["data"])
            else:
                t0, d0 = [], []
            np.savez(path, t=np.asarray(t0 + self._t),
                     data=np.asarray(d0 + frames))
        self._buf = {}
        self._t = []


def read_slices(path):
    with np.load(path) as z:
        return z["t"], z["data"]
