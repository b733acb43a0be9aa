"""Immersed solid bodies on a Cartesian grid — the reference's solid_cells
module (src/solid_cells.f90): cylinders (and spheres) embedded in the flow,
represented by "mirror"-interpolated ghost points inside the body.

JAX-native design: the geometry is STATIC, so the entire reference decision
tree (find_solid_cell_boundaries :2498, update_solid_cells :1016,
close_interpolation :1825 / close_inter_new :1988 with
find_g_global_closest_gridplane :2173, fp_nearest_grid :459) is evaluated
ONCE in float64 numpy at trace time, producing flat gather indices, bilinear
weights and per-point 3×3 velocity transfer matrices.  The per-substep
``update_f`` is then three vectorized gather→matmul→scatter ops; the solid
interior is frozen by masking df (freeze_solid_cells :2432).

Supported (the cylinder_deposition sample family): 2-D cylinder objects,
interpolation_method='mirror', close_interpolation_method>=2 with
lclose_quad_rad_inter (quadratic radial / linear tangential interpolation
between the body surface and the first grid plane crossed by the surface
normal).  One deliberate deviation: the reference updates ghost points
sequentially in place (Gauss–Seidel in loop order) while we scatter each
phase at once (Jacobi within a phase, '10'-points before mirror points like
the reference's two loops); the difference only touches ghost corners of
near-surface interpolation cells and is far below golden tolerances.

Drag coefficients (dsolid_dt :687 + dsolid_dt_integrate :873): surface
force points at robj, pressure + viscous stress from the nearest outside
grid point, normalized by 2/(ρ̄_fluid·init_uu²)/(2robj)·dlong·rforce.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Tuple

import jax.numpy as jnp
import numpy as np

from .base import ModuleBase


def _as_tuple(v):
    if v is None:
        return ()
    if isinstance(v, (list, tuple)):
        return tuple(float(x) for x in v)
    return (float(v),)


@dataclass(frozen=True)
class SolidCells(ModuleBase):
    name: ClassVar[str] = "solid_cells"

    ncylinders: int = 0
    cylinder_radius: Tuple[float, ...] = ()
    cylinder_xpos: Tuple[float, ...] = ()
    cylinder_ypos: Tuple[float, ...] = ()
    cylinder_zpos: Tuple[float, ...] = ()
    cylinder_temp: Tuple[float, ...] = ()
    initsolid_cells: str = "nothing"
    init_uu: float = 0.0
    skin_depth: float = 0.0
    ampl_noise: float = 0.0
    interpolation_method: str = "mirror"
    nforcepoints: int = 200
    close_interpolation_method: int = 1
    lclose_interpolation: bool = False
    lclose_linear: bool = False
    limit_close_linear: float = 0.5
    ineargridshift: float = 1.0
    theta_shift: float = 1e-2
    seed0: int = 1812
    rng_kind: str = "min_std"   # random_gen (general.f90:178 default)

    # ---- static geometry -------------------------------------------------
    def _geometry(self, cfg):
        cache = getattr(self, "_geom_cache", None)
        if cache is not None:
            return cache
        gs = cfg.grid
        if gs.coords != "cartesian" or self.interpolation_method != "mirror":
            raise NotImplementedError(
                "solid_cells v1: cartesian 'mirror' method only")
        if self.ncylinders < 1:
            raise NotImplementedError("solid_cells v1: cylinders only")
        g = gs.nghost
        from ..core.grid import _axis_coords
        sh = [0.5 * d if ls else 0.0 for ls, d in
              zip(gs.lshift_origin, (gs.dx, gs.dy, gs.dz))]
        xg, _, _ = _axis_coords(gs.nx, gs.x0 + sh[0], gs.Lx, gs.periodic[0],
                                g, gs.grid_func[0], gs.grid_coeff[0],
                                np.float64)
        yg, _, _ = _axis_coords(gs.ny, gs.y0 + sh[1], gs.Ly, gs.periodic[1],
                                g, gs.grid_func[1], gs.grid_coeff[1],
                                np.float64)
        x = xg[g:-g]
        y = yg[g:-g]
        nx, ny = gs.nx, gs.ny
        dxmin = min(d for d, n in ((gs.dx, nx), (gs.dy, ny), (gs.dz, gs.nz))
                    if n > 1)
        objs = [(self.cylinder_radius[i], self.cylinder_xpos[i],
                 self.cylinder_ypos[i]) for i in range(self.ncylinders)]

        ba1 = np.zeros((nx, ny), np.int32)
        ba2 = np.zeros((nx, ny), np.int32)
        ba4 = np.zeros((nx, ny), np.int32)
        for iobj, (r0, x0, y0) in enumerate(objs, start=1):
            # x-scan (find_solid_cell_boundaries :2546-2660)
            for j in range(ny):
                x2 = r0 * r0 - (y[j] - y0) ** 2
                if x2 <= 0:
                    continue
                xp_, xm_ = x0 + math.sqrt(x2), x0 - math.sqrt(x2)
                for i in range(nx):
                    if not (xm_ < x[i] < xp_):
                        continue
                    gi = i + g   # into ghosted xg
                    v = 0
                    for k in range(1, 5):
                        if xg[gi + k] > xp_ and (k == 1
                                                 or xg[gi + k - 1] < xp_):
                            v = -k
                    for k in range(1, 5):
                        if xg[gi - k] < xm_ and (k == 1
                                                 or xg[gi - k + 1] > xm_):
                            v = k
                    ba1[i, j] = v if v else 9
                    ba4[i, j] = iobj
            # y-scan
            for i in range(nx):
                y2 = r0 * r0 - (x[i] - x0) ** 2
                if y2 <= 0:
                    continue
                yp_, ym_ = y0 + math.sqrt(y2), y0 - math.sqrt(y2)
                for j in range(ny):
                    if not (ym_ < y[j] < yp_):
                        continue
                    gj = j + g
                    v = 0
                    for k in range(1, 5):
                        if yg[gj + k] > yp_ and (k == 1
                                                 or yg[gj + k - 1] < yp_):
                            v = -k
                    for k in range(1, 5):
                        if yg[gj - k] < ym_ and (k == 1
                                                 or yg[gj - k + 1] > ym_):
                            v = k
                    ba2[i, j] = v if v else 9
                    ba4[i, j] = iobj
            # near-surface fluid marking (:2915-2936)
            if self.lclose_linear:
                rr = np.sqrt((x[:, None] - x0) ** 2 + (y[None, :] - y0) ** 2)
                dr = rr - r0
                m10 = (dr >= 0) & (dr < self.limit_close_linear * dxmin)
                ba1[m10] = 10
                ba2[m10] = 10
                ba4[m10] = iobj

        solid = (ba1 != 0) & (ba1 != 10)
        close10 = ba1 == 10

        # ---- close-interpolation helper (close_inter_new :1988) ---------
        def _gplane(p, cell_lo, o, rs, rp):
            """g on the first gridplane crossed by the surface normal
            beyond p (find_g_global_closest_gridplane :2173).  Returns
            (2-pt gather (i,j) pairs, weights, rg)."""
            pl_ = p - o
            corner_val = [(x[cell_lo[0]], x[cell_lo[0] + 1]),
                          (y[cell_lo[1]], y[cell_lo[1] + 1])]
            rlmin = 1e30
            constdir = topbot = -1
            for d in range(2):
                for tb in range(2):
                    rl = (corner_val[d][tb] - o[d]) / pl_[d]
                    if rl > 1.0 and rl < rlmin:
                        rlmin = rl
                        constdir, topbot = d, tb
            if constdir < 0:
                raise RuntimeError("solid_cells: no valid g-plane")
            gg = rlmin * pl_ + o
            gg[constdir] = corner_val[constdir][topbot]
            rg = rlmin * math.hypot(pl_[0], pl_[1])
            # clamp into the cell (roundoff, :2272-2287)
            for d in range(2):
                gg[d] = min(max(gg[d], corner_val[d][0]), corner_val[d][1])
            # interpolation cell on the plane: lower corner index
            if constdir == 0:
                li = cell_lo[0] + topbot
                lj = cell_lo[1]
                t = (gg[1] - y[lj]) / gs.dy
                pts = [(li, lj), (li, lj + 1)]
            else:
                lj = cell_lo[1] + topbot
                li = cell_lo[0]
                t = (gg[0] - x[li]) / gs.dx
                pts = [(li, lj), (li + 1, lj)]
            return pts, np.array([1.0 - t, t]), rg

        def _unit_vectors(pl_):
            th = math.atan2(pl_[1], pl_[0])
            nr = np.array([math.cos(th), math.sin(th), 0.0])
            nth = np.array([-math.sin(th), math.cos(th), 0.0])
            nph = np.array([0.0, 0.0, 1.0])
            return nr, nth, nph

        def _transfer(pl_, rp, rs, rg):
            """3×3 matrix: u_p = M · u_g (vp_r = vg_r·(r_sp/r_sg)²,
            tangential linear, close_inter_new :2109-2126)."""
            nr, nth, nph = _unit_vectors(pl_)
            r_sg = rg - rs
            r_sp = rp - rs
            lin = r_sp / r_sg
            return (np.outer(nr, nr) * lin * lin
                    + (np.outer(nth, nth) + np.outer(nph, nph)) * lin)

        smallx = gs.dx * 1e-5

        # ---- phase 1: '10' fluid points (update_solid_cells :1039-1069) -
        p1_idx, p1_gat, p1_w, p1_M = [], [], [], []
        if self.lclose_linear:
            for i in range(nx):
                for j in range(ny):
                    if ba1[i, j] != 10:
                        continue
                    iobj = ba4[i, j] - 1
                    r0, x0, y0 = objs[iobj]
                    rp = math.hypot(x[i] - x0, y[j] - y0)
                    dr = rp - r0
                    if not (0 < dr < dxmin * self.limit_close_linear):
                        continue
                    o = np.array([x0, y0])
                    p = np.array([x[i], y[j]])
                    # find_corner_points fluid_point=True (:2338-2361)
                    ci = i - 1 if p[0] < x0 else i
                    cj = j - 1 if p[1] < y0 else j
                    p_sh = p + np.where(p < o, -smallx, smallx)
                    rp_sh = math.hypot(p_sh[0] - x0, p_sh[1] - y0)
                    pts, w2, rg = _gplane(p_sh, (ci, cj), o, r0, rp_sh)
                    M = _transfer(p_sh - o, rp_sh, r0, rg)
                    p1_idx.append(i * ny + j)
                    p1_gat.append([a * ny + b for a, b in pts])
                    p1_w.append(w2)
                    p1_M.append(M)

        # ---- phase 2: mirror ghost points (:1073-1234) -------------------
        p2_idx, p2_gat, p2_w, p2_M = [], [], [], []
        p2_rgat, p2_rw = [], []
        for i in range(nx):
            for j in range(ny):
                bax = ba1[i, j] not in (0, 9, 10)
                bay = ba2[i, j] not in (0, 9, 10)
                if not (bax or bay):
                    continue
                iobj = ba4[i, j] - 1
                r0, x0, y0 = objs[iobj]
                o = np.array([x0, y0])
                rpt = math.hypot(x[i] - x0, y[j] - y0)
                r_new = 2.0 * r0 - rpt
                mir = o + (np.array([x[i], y[j]]) - o) * (r_new / rpt)
                # find_near_indeces: containing cell (interior indices)
                mi = int(np.searchsorted(x, mir[0]) - 1)
                mj = int(np.searchsorted(y, mir[1]) - 1)
                mi = min(max(mi, 0), nx - 2)
                mj = min(max(mj, 0), ny - 2)
                tx_ = (mir[0] - x[mi]) / gs.dx
                ty_ = (mir[1] - y[mj]) / gs.dy
                corners = [(mi, mj), (mi + 1, mj), (mi, mj + 1),
                           (mi + 1, mj + 1)]
                w4 = np.array([(1 - tx_) * (1 - ty_), tx_ * (1 - ty_),
                               (1 - tx_) * ty_, tx_ * ty_])
                # density: zero surface gradient — mirror interpolation
                # (interpolate_point_new :1810-1821)
                p2_rgat.append([a * ny + b for a, b in corners])
                p2_rw.append(w4)
                # velocity: close interpolation when the mirror cell
                # touches the body or the mirror point is very close
                rij = min(math.hypot(x[a] - x0, y[b] - y0)
                          for a, b in corners)
                use_close = (self.lclose_interpolation
                             and (rij < r0
                                  or r_new < r0 + self.limit_close_linear
                                  * dxmin))
                if use_close:
                    pts, w2, rg = _gplane(mir, (mi, mj), o, r0, r_new)
                    M = -_transfer(mir - o, r_new, r0, rg)
                    gat = [a * ny + b for a, b in pts] + [0, 0]
                    w = np.array([w2[0], w2[1], 0.0, 0.0])
                else:
                    M = -np.eye(3)
                    gat = [a * ny + b for a, b in corners]
                    w = w4
                p2_idx.append(i * ny + j)
                p2_gat.append(gat)
                p2_w.append(w)
                p2_M.append(M)

        # ---- drag force points (fp_nearest_grid :459, dsolid_dt :687) ----
        r0, x0, y0 = objs[0]
        nfp = self.nforcepoints
        dlong = 2.0 * math.pi / nfp
        rforce = r0 + dxmin * self.ineargridshift
        fp_idx, fp_nvec = [], []
        for ifp in range(1, nfp + 1):
            longitude = (ifp - self.theta_shift) * dlong
            fpx = x0 - r0 * math.sin(longitude)
            fpy = y0 - r0 * math.cos(longitude)
            il = min(max(int(np.searchsorted(x, fpx) - 1), 0), nx - 2)
            jl = min(max(int(np.searchsorted(y, fpy) - 1), 0), ny - 2)
            best, bd = None, 1e30
            for a, b in ((il, jl), (il + 1, jl), (il + 1, jl + 1),
                         (il, jl + 1)):
                if math.hypot(x[a] - x0, y[b] - y0) <= r0:
                    continue
                d2 = (x[a] - fpx) ** 2 + (y[b] - fpy) ** 2
                if best is None or d2 <= bd:
                    best, bd = (a, b), d2
            fp_idx.append(best[0] * ny + best[1])
            fp_nvec.append([-math.sin(longitude), -math.cos(longitude)])

        geom = {
            "solid": jnp.asarray(solid),            # (nx, ny) bool
            "close10": jnp.asarray(close10),
            "fluid_frac": jnp.asarray(~(solid | close10)),
            "p1_idx": jnp.asarray(np.asarray(p1_idx, np.int32)),
            "p1_gat": jnp.asarray(np.asarray(p1_gat, np.int32).reshape(-1, 2)),
            "p1_w": jnp.asarray(np.asarray(p1_w, np.float64).reshape(-1, 2)
                                .astype(np.float32)),
            "p1_M": jnp.asarray(np.asarray(p1_M, np.float64).reshape(-1, 3, 3)
                                .astype(np.float32)),
            "p2_idx": jnp.asarray(np.asarray(p2_idx, np.int32)),
            "p2_gat": jnp.asarray(np.asarray(p2_gat, np.int32).reshape(-1, 4)),
            "p2_w": jnp.asarray(np.asarray(p2_w, np.float64).reshape(-1, 4)
                                .astype(np.float32)),
            "p2_M": jnp.asarray(np.asarray(p2_M, np.float64).reshape(-1, 3, 3)
                                .astype(np.float32)),
            "p2_rgat": jnp.asarray(np.asarray(p2_rgat, np.int32)
                                   .reshape(-1, 4)),
            "p2_rw": jnp.asarray(np.asarray(p2_rw, np.float64).reshape(-1, 4)
                                 .astype(np.float32)),
            "fp_idx": jnp.asarray(np.asarray(fp_idx, np.int32)),
            "fp_nvec": jnp.asarray(np.asarray(fp_nvec, np.float64)
                                   .astype(np.float32)),
            "surfel": dlong * rforce / max(gs.nz, 1),
            "drag_norm": 1.0 / (2.0 * r0),
        }
        object.__setattr__(self, "_geom_cache", geom)
        return geom

    # ---- initial condition (init_solid_cells :263-457) -------------------
    def init_fields(self, grid, spec, eos, key, cfg=None, fields=None):
        if self.initsolid_cells == "nothing":
            return {}
        if self.initsolid_cells != "cylinderstream_y":
            raise NotImplementedError(
                f"initsolid_cells={self.initsolid_cells!r}")
        import numpy as np
        g = spec.nghost
        x = np.asarray(grid.x, np.float64)[g:-g]
        y = np.asarray(grid.y, np.float64)[g:-g]
        nx, ny, nz = spec.nx, spec.ny, spec.nz
        # reference-RNG gaussian noise replay (gaunoise over uu, then
        # stream function added on top; init_solid_cells :384)
        from ..compat.pencil_rng import Ran0, gaunoise_vect, start_seed
        if self.rng_kind == "min_std":
            # gaunoise is this stream's first consumer (start.f90:440
            # init_solid_cells; hydro/density draw nothing before it here)
            rng = Ran0(-((self.seed0 - 1812 + 1) * 10))
        else:
            rng = start_seed(self.seed0)
        mx, my, mz = nx + 2 * g, ny + 2 * g, nz + 2 * g
        noise = gaunoise_vect(rng, self.ampl_noise, mx, my, mz, 3)
        uu = np.array(noise[:, g:-g, g:-g, g:-g], np.float64)
        uu[1] += self.init_uu
        a2 = self.cylinder_radius[0] ** 2
        y0 = self.cylinder_ypos[0]
        Lx = spec.Lx
        xr = x[:, None]
        yr = y[None, :] - y0
        rr2 = xr ** 2 + yr ** 2
        outside = rr2 > a2
        with np.errstate(divide="ignore", invalid="ignore"):
            wall = 1.0 - np.exp(-(rr2 - a2) / self.skin_depth ** 2)
            dux = -self.init_uu * 2.0 * xr * yr * a2 / rr2 ** 2 * wall
            duy = self.init_uu * (-a2 / rr2 + 2.0 * xr ** 2 * a2 / rr2 ** 2) \
                * wall
            for cyl in range(1, 101):
                shiftx = cyl * Lx
                r2l = (xr + shiftx) ** 2 + yr ** 2
                r2h = (xr - shiftx) ** 2 + yr ** 2
                duy = duy + self.init_uu * (
                    2.0 * (xr - shiftx) ** 2 * a2 / r2h ** 2 - a2 / r2h
                    + 2.0 * (xr + shiftx) ** 2 * a2 / r2l ** 2 - a2 / r2l)
                # NB: the reference image term uses the ABSOLUTE y(j), not
                # yr = y − y0 (init_solid_cells :424-428) — replicated for
                # golden parity
                yabs = y[None, :]
                dux = dux - self.init_uu * (
                    (xr - shiftx) * yabs * 2.0 * a2 / r2h ** 2
                    + (xr + shiftx) * yabs * 2.0 * a2 / r2l ** 2)
        uu[0] += np.where(outside, dux, 0.0)[:, :, None]
        uu[1] += np.where(outside, duy, 0.0)[:, :, None]
        # in-body velocity is ZERO.  The current reference source leaves
        # noise + init_uu·ŷ inside the cylinder (init_solid_cells :431
        # touches only T), but the committed reference.out corresponds to
        # a zeroed interior: with u=0 inside, ozm/oz2m/urms/umax all
        # reproduce the reference's it=0 row to format precision (e.g.
        # oz2m = 1.0372069552e5), with noise+5ŷ inside they do not.
        uu[:, ~outside, :] = 0.0
        # last 6 interior y rows: ux = 0 (:442)
        uu[0, :, -6:, :] = 0.0
        return {"uu": jnp.asarray(uu.astype(np.float32))}

    # ---- per-substep ghost-zone update (update_solid_cells :1016) --------
    def update_f(self, fa, grid, model):
        geom = self._geometry(model.cfg)
        reg = model.reg
        gs = model.cfg.grid
        nx, ny, nz = fa.shape[1], fa.shape[2], fa.shape[3]
        if (nx, ny, nz) != gs.shape:
            raise NotImplementedError("solid_cells: sharded mesh")
        sl_u = reg.slice("uu")
        u = fa[sl_u].reshape(3, nx * ny, nz)
        if geom["p1_idx"].shape[0]:
            gat = u[:, geom["p1_gat"], :]                    # (3, n, 2, z)
            ug = jnp.einsum("cngz,ng->cnz", gat, geom["p1_w"])
            unew = jnp.einsum("nij,jnz->inz", geom["p1_M"], ug)
            u = u.at[:, geom["p1_idx"], :].set(unew)
        if geom["p2_idx"].shape[0]:
            # two Jacobi passes: a mirror/g-plane interpolation source can
            # itself be a ghost point — the reference's in-place loop
            # (Gauss–Seidel) sees it freshly updated; the second pass
            # re-gathers from once-updated values, converging to the same
            # fixed point
            for _ in range(2):
                gat = u[:, geom["p2_gat"], :]                # (3, n, 4, z)
                ug = jnp.einsum("cngz,ng->cnz", gat, geom["p2_w"])
                unew = jnp.einsum("nij,jnz->inz", geom["p2_M"], ug)
                u = u.at[:, geom["p2_idx"], :].set(unew)
        fa = fa.at[sl_u].set(u.reshape(3, nx, ny, nz))
        rname = "rho" if "rho" in reg.slots else "lnrho"
        if rname in reg.slots and geom["p2_idx"].shape[0]:
            sl_r = reg.slice(rname)
            r = fa[sl_r].reshape(-1, nx * ny, nz)
            rg = jnp.einsum("cngz,ng->cnz", r[:, geom["p2_rgat"], :],
                            geom["p2_rw"])
            r = r.at[:, geom["p2_idx"], :].set(rg)
            fa = fa.at[sl_r].set(r.reshape(-1, nx, ny, nz))
        return fa

    def post_init(self, fields, model):
        """Apply the ghost/'10'-point update to the assembled initial state
        (the reference's first update_solid_cells runs inside the first pde
        call, before the it=0 diagnostics)."""
        reg = model.reg
        fa = reg.stack(fields)
        fa = self.update_f(fa, model.grid, model)
        return reg.unstack_update(fields, fa) \
            if hasattr(reg, "unstack_update") else _unstack(reg, fields, fa)

    # ---- freeze (freeze_solid_cells :2432) --------------------------------
    def adjust_df(self, pen, df, ts):
        geom = self._geometry(pen.cfg)
        solid = geom["solid"][None, :, :, None]
        c10 = geom["close10"][None, :, :, None]
        for name in list(df.keys()):
            if name == "uu":
                df[name] = jnp.where(solid | c10, 0.0, df[name])
            else:
                d = df[name]
                mask = (solid | c10) if name in ("lnTT", "TT") else solid
                if d.ndim == 3:
                    df[name] = jnp.where(mask[0], 0.0, d)
                else:
                    df[name] = jnp.where(mask, 0.0, d)


def _unstack(reg, fields, fa):
    out = dict(fields)
    for name, slot in reg.slots.items():
        if slot.kind != "pde" and name not in fields:
            continue
        sl = reg.slice(name)
        arr = fa[sl]
        out[name] = arr[0] if (slot.ncomp == 1
                               and fields[name].ndim == 3) else arr
    return out
