"""Yin-Yang overset spherical grids (reference ``src/yinyang.f90`` +
the ``yyinit``/``setup_interp_yy`` machinery in
``src/mpicomm.f90:606-1323``): two identical spherical-coordinate
patches — "yin" covering θ∈[π/4,3π/4], φ∈[−3π/4,3π/4] and "yang", the
same patch in a frame rotated so that (x,y,z)_yang = (−x,z,y)_yin —
jointly cover the full sphere with no pole singularity.  Each patch's
θ/φ boundary ghosts are interpolated from the OTHER patch's interior
(biquadratic in the reference; bilinear here), with vector components
rotated between the two bases.

JAX-native realization: the two patches ride a leading axis of size 2 on
every field (one batched program, not two programs), and the reference's
precomputed coefficient tables + rank-to-rank exchange collapse to
STATIC gather indices/weights built once at setup — the ghost exchange
is two vectorized gathers and a 3×3 matrix multiply per ghost point,
fully inside jit.  The rotation is an involution, so ONE table serves
both directions.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops.stencil import NGHOST


def _rotate_xyz(x, y, z):
    """The yin↔yang frame map (self-inverse): (x,y,z) → (−x, z, y)."""
    return -x, z, y


def _sph_to_cart(th, ph):
    return (np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th))


def _other_patch_coords(th, ph):
    """(θ,φ) of a point expressed in the other patch's frame."""
    x, y, z = _sph_to_cart(th, ph)
    xo, yo, zo = _rotate_xyz(x, y, z)
    tho = np.arccos(np.clip(zo, -1.0, 1.0))
    pho = np.arctan2(yo, xo)
    return tho, pho


def _basis(th, ph):
    """Columns (r̂, θ̂, φ̂) as a 3×3 matrix for each point."""
    st, ct = np.sin(th), np.cos(th)
    sp, cp = np.sin(ph), np.cos(ph)
    M = np.empty(th.shape + (3, 3))
    M[..., :, 0] = np.stack([st * cp, st * sp, ct], -1)       # r̂
    M[..., :, 1] = np.stack([ct * cp, ct * sp, -st], -1)      # θ̂
    M[..., :, 2] = np.stack([-sp, cp, 0.0 * th], -1)          # φ̂
    return M


_R = np.array([[-1.0, 0.0, 0.0],
               [0.0, 0.0, 1.0],
               [0.0, 1.0, 0.0]])


@dataclass(frozen=True)
class YinYangSpec:
    """Geometry of one patch (both patches are identical)."""

    nr: int = 16
    nth: int = 32
    nph: int = 96
    r0: float = 0.5
    r1: float = 1.0
    overlap: int = NGHOST     # extra interior cells beyond the core patch

    @property
    def dth(self):
        return (np.pi / 2) / (self.nth - 1 - 2 * self.overlap)

    @property
    def th(self):
        o = self.overlap
        return (np.pi / 4 - o * self.dth) + self.dth * np.arange(self.nth)

    @property
    def dph(self):
        return (1.5 * np.pi) / (self.nph - 1 - 2 * self.overlap)

    @property
    def ph(self):
        o = self.overlap
        return (-0.75 * np.pi - o * self.dph) \
            + self.dph * np.arange(self.nph)

    @property
    def dr(self):
        return (self.r1 - self.r0) / max(self.nr - 1, 1)

    @property
    def r(self):
        return self.r0 + self.dr * np.arange(self.nr)


def build_interp_tables(spec: YinYangSpec):
    """Ghost-point interpolation tables (the analog of setup_interp_yy,
    mpicomm.f90:756-1323).

    For every ghost point of the θ and φ boundaries (g layers each side,
    full extent of the other horizontal axis), returns
      idx_th, idx_ph — lower-corner indices into the OTHER patch's grid
      w — bilinear weights (4,)
      rot — 3×3 vector-rotation matrix (other basis → this basis)
    flattened over all ghost points, plus the (slice) scatter metadata.
    """
    g = NGHOST
    th, ph = spec.th, spec.ph
    # ghosted coordinate vectors
    thg = np.concatenate([th[0] - spec.dth * np.arange(g, 0, -1), th,
                          th[-1] + spec.dth * np.arange(1, g + 1)])
    phg = np.concatenate([ph[0] - spec.dph * np.arange(g, 0, -1), ph,
                          ph[-1] + spec.dph * np.arange(1, g + 1)])
    mth, mph = len(thg), len(phg)

    # ghost-point (θ,φ) lists: θ-ghost bands span the FULL ghosted φ
    # extent; φ-ghost bands span the interior θ only (corners belong to
    # the θ bands) — together every horizontal ghost cell is covered once
    pts = []
    scat = []
    for i in list(range(g)) + list(range(mth - g, mth)):
        for j in range(mph):
            pts.append((thg[i], phg[j]))
            scat.append((i, j))
    for i in range(g, mth - g):
        for j in list(range(g)) + list(range(mph - g, mph)):
            pts.append((thg[i], phg[j]))
            scat.append((i, j))
    pts = np.asarray(pts)
    scat = np.asarray(scat)

    tho, pho = _other_patch_coords(pts[:, 0], pts[:, 1])
    # bilinear cell in the other patch's INTERIOR grid
    fi = (tho - th[0]) / spec.dth
    fj = (pho - ph[0]) / spec.dph
    i0 = np.clip(np.floor(fi).astype(int), 0, spec.nth - 2)
    j0 = np.clip(np.floor(fj).astype(int), 0, spec.nph - 2)
    di = fi - i0
    dj = fj - j0
    if (fi < -1e-6).any() or (fi > spec.nth - 1 + 1e-6).any() \
            or (fj < -1e-6).any() or (fj > spec.nph - 1 + 1e-6).any():
        raise ValueError(
            "yin-yang ghost point falls outside the other patch — "
            "increase the overlap or the resolution")
    w = np.stack([(1 - di) * (1 - dj), (1 - di) * dj,
                  di * (1 - dj), di * dj], axis=-1)

    # vector rotation: this-basis ← other-basis at the ghost point
    Mg = _basis(pts[:, 0], pts[:, 1])          # this patch
    Mo = _basis(tho, pho)                       # other patch
    rot = np.einsum("nij,jk,nkl->nil",
                    np.swapaxes(Mg, 1, 2), _R, Mo)

    return dict(
        i0=jnp.asarray(i0), j0=jnp.asarray(j0), w=jnp.asarray(w),
        rot=jnp.asarray(rot), scat=jnp.asarray(scat),
        mth=mth, mph=mph,
    )


def exchange_horizontal_ghosts(fg_pair, tables, vector_slots):
    """Fill θ/φ ghost zones of both patches from each other's interior.

    fg_pair: (2, nc, mr, mth, mph) ghosted stacks (patch axis first).
    vector_slots: list of (start, 3) component ranges needing rotation
    (the (r,θ,φ) components of velocity/field vectors).
    Returns the pair with horizontal ghosts replaced."""
    g = NGHOST
    i0, j0, w, rot = (tables[k] for k in ("i0", "j0", "w", "rot"))
    scat = tables["scat"]
    out = []
    for p in range(2):
        me = fg_pair[p]
        other = fg_pair[1 - p][:, :, g:-g, g:-g]   # interior θ/φ (keep mr)
        # gather the 4 bilinear corners: (nc, mr, npts)
        vals = (w[:, 0] * other[:, :, i0, j0]
                + w[:, 1] * other[:, :, i0, j0 + 1]
                + w[:, 2] * other[:, :, i0 + 1, j0]
                + w[:, 3] * other[:, :, i0 + 1, j0 + 1])
        # rotate vector components (per ghost point 3×3)
        for (s0, _n) in vector_slots:
            v = vals[s0:s0 + 3]                      # (3, mr, npts)
            vals = vals.at[s0:s0 + 3].set(
                jnp.einsum("nij,jmn->imn", rot, v))
        me = me.at[:, :, scat[:, 0], scat[:, 1]].set(vals)
        out.append(me)
    return jnp.stack(out)


class YinYangModel:
    """Coupled two-patch stepper (the analog of running the reference
    with ``lyinyang``: both patch grids advance the same physics, and
    every ghost fill routes the horizontal boundaries through the
    overset interpolation instead of physical BCs).

    ``modules`` may be one tuple (used for both patches) or a pair of
    tuples when a module needs patch-frame-specific parameters (e.g. the
    'rigid-x' kinematic flow is rotation about +x̂ in yin coordinates and
    −x̂ in yang's)."""

    def __init__(self, spec: YinYangSpec, modules, dtype="float32",
                 bcx=(), time=None):
        import jax.numpy as jnp

        from ..core.config import Config, GridSpec, TimeSpec
        from ..model import Model

        self.spec = spec
        gs = GridSpec(
            nx=spec.nr, ny=spec.nth, nz=spec.nph,
            x0=spec.r0, Lx=spec.r1 - spec.r0,
            y0=float(spec.th[0]), Ly=float(spec.th[-1] - spec.th[0]),
            z0=float(spec.ph[0]), Lz=float(spec.ph[-1] - spec.ph[0]),
            periodic=(False, False, False),
            coords="spherical",
        )
        mods = modules if isinstance(modules[0], (tuple, list)) \
            else (modules, modules)
        self.cfgs = tuple(
            Config(grid=gs, dtype=dtype,
                   time=time or TimeSpec(itorder=3), modules=tuple(m),
                   bcx=tuple(bcx))
            for m in mods)
        self.models = tuple(Model(c) for c in self.cfgs)
        self.reg = self.models[0].reg
        self.tables = build_interp_tables(spec)
        self.vector_slots = [
            (self.reg.slice(n).start, 3)
            for n, slot in self.reg.slots.items() if slot.ncomp == 3
        ]

    def init_state(self, seed=0):
        import jax.numpy as jnp
        s0 = self.models[0].init_state(seed)
        s1 = self.models[1].init_state(seed + 1)
        fields = {
            k: jnp.stack([s0["fields"][k], s1["fields"][k]])
            for k in s0["fields"]
        }
        return {**s0, "fields": fields}

    def _fg_pair(self, fa_pair):
        import jax.numpy as jnp

        from .halo import fill_ghosts
        fgs = []
        for p in range(2):
            m = self.models[p]
            cfg = self.cfgs[p]
            fg = fill_ghosts(fa_pair[p][: self.reg.ncom], cfg.grid,
                             (cfg.bcx, (), ()), self.reg, m.grid, cfg,
                             m.eos)
            fgs.append(fg)
        return exchange_horizontal_ghosts(jnp.stack(fgs), self.tables,
                                          self.vector_slots)

    def rhs_pair(self, fa_pair, t=0.0):
        import jax.numpy as jnp

        from ..integrate.timestep import cfl_dt1
        from ..physics.base import TimestepAccum
        from ..physics.pencils import Pencils
        fg_pair = self._fg_pair(fa_pair)
        dfs, dt1s = [], []
        for p in range(2):
            m = self.models[p]
            pen = Pencils(fg_pair[p], m.grid, self.reg, self.cfgs[p],
                          m.eos)
            df = {}
            ts = TimestepAccum()
            for mod in m.modules:
                mod.rhs(pen, df, ts)
            parts = []
            for name, slot in self.reg.slots.items():
                if slot.kind != "pde":
                    continue
                d = df.get(name)
                if d is None:
                    d = jnp.zeros((slot.ncomp,) + fa_pair.shape[2:],
                                  fa_pair.dtype)
                elif d.ndim == 3:
                    d = d[None]
                parts.append(d)
            dfs.append(jnp.concatenate(parts, axis=0))
            d1m = pen.dline_1()
            ts.dxyz2 = d1m[0] ** 2 + d1m[1] ** 2 + d1m[2] ** 2
            dt1s.append(jnp.max(cfl_dt1(ts, m.grid, self.cfgs[p].time)))
        return jnp.stack(dfs), jnp.maximum(dt1s[0], dt1s[1])

    def make_step(self):
        import jax
        import jax.numpy as jnp

        from ..integrate.timestep import RK_TABLES
        reg = self.reg
        tcfg = self.cfgs[0].time
        alpha, beta, cstage = RK_TABLES[tcfg.itorder]

        @jax.jit
        def step(state):
            fa = jnp.stack([reg.stack(
                {k: v[p] for k, v in state["fields"].items()})
                for p in range(2)])
            nvar = reg.nvar
            df = jnp.zeros((2, nvar) + fa.shape[2:], fa.dtype)
            dt = state["dt"]
            t0 = state["t"]
            for isub in range(len(alpha)):
                dfa, dt1 = self.rhs_pair(fa, t0 + cstage[isub] * dt)
                if isub == 0:
                    dt = (jnp.asarray(tcfg.dt, fa.dtype)
                          if tcfg.dt > 0 else
                          (1.0 / jnp.maximum(dt1, 1.0 / tcfg.dtmax)
                           ).astype(fa.dtype))
                df = alpha[isub] * df + dfa if isub > 0 else dfa
                fa = fa.at[:, :nvar].add(beta[isub] * dt * df)
            fields = {}
            off = {n: reg.slice(n) for n in reg.slots}
            for n, sl in off.items():
                arr = fa[:, sl]
                fields[n] = arr[:, 0] if reg.slots[n].ncomp == 1 else arr
            return {**state, "fields": fields, "t": t0 + dt, "dt": dt,
                    "it": state["it"] + 1}

        return step
