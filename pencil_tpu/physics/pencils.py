"""Lazy derived-field container — the pencil mechanism, array style.

The reference strip-mines the RHS one x-line at a time, filling a generated
``pencil_case`` struct of derived quantities per (m,n) iteration
(``src/equ.f90:713-814`` calc_all_pencils; codegen in §2.1 of SURVEY.md).
Here the whole local block is "the pencil": derived fields are memoized
lazily on first access, the dependency closure the reference computes via
``pencil_interdep`` fixed-point iteration (src/register.f90:579-751) falls
out of Python attribute access order, and XLA's CSE/fusion removes any
redundancy inside the jitted step.

All quantities are *interior*-shaped (nx, ny, nz); derivatives read the
ghosted stack ``fg``.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops import stencil as st
from ..ops.stencil import i as interior


def _memo(fn):
    name = fn.__name__

    def wrapper(self, *args):
        key = (name, args) if args else name
        if key not in self._cache:
            self._cache[key] = fn(self, *args)
        return self._cache[key]

    return wrapper


_OTHER_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


class Pencils:
    def __init__(self, fg, grid, reg, cfg, eos=None,
                 mesh_axis_names=None, mesh_shape=(1, 1, 1)):
        self.fg = fg            # ghosted stack (nc, mx, my, mz)
        self.grid = grid
        self.reg = reg
        self.cfg = cfg
        self.eos = eos
        # mesh topology of the enclosing shard_map region (None axis names
        # = unsharded); modules needing GLOBAL operations (self-gravity
        # Poisson solve, spectral transforms) must consult these rather
        # than operating on the local shard alone.
        self.mesh_axis_names = mesh_axis_names
        self.mesh_shape = mesh_shape
        # ghost width: follows GridSpec.nghost (3=6th, 4=8th, 5=10th order)
        self._g = cfg.grid.nghost if cfg is not None else 3
        self._cache = {}

    # ---- raw derivative helpers (on stacked slices) --------------------
    def _inv(self, axis):
        """Physical inverse line element (metric-scaled off-cartesian:
        1/h_i · 1/Δξ_i; see physics/curvilinear.py)."""
        if self.cfg is not None and self.cfg.grid.coords != "cartesian":
            from .curvilinear import dline_1_curv
            key = "_dline_curv"
            if key not in self._cache:
                self._cache[key] = dline_1_curv(self)
            return self._cache[key][axis]
        return (self.grid.dx1, self.grid.dy1, self.grid.dz1)[axis]

    def dline_1(self):
        return tuple(self._inv(a) for a in range(3))

    @_memo
    def vol_weight(self):
        """Normalized volume weights for curvilinear volume averages
        (reference diagnostics: sum_mn sums carry dV = r dr dφ dz /
        r²sinθ dr dθ dφ — a plain jnp.mean is wrong off-cartesian).
        Returns None on cartesian grids; else w with mean(w) = 1 so
        ⟨x⟩_V = mean(x·w)."""
        if self.cfg is None:
            return None
        gs = self.cfg.grid
        if gs.coords == "cartesian":
            # cartesian sum_mn is a PLAIN mean (diagnostics.f90: the
            # r²/sinθ/rcyl weights and their ½-edge factors exist only
            # for curvilinear coords, grid.f90:1138-1161)
            return None
        # the weights depend only on STATIC grid geometry — rebuild the
        # coordinate vectors from the GridSpec in float64 numpy (never
        # from self.grid arrays, which ride traced through jit/shard_map;
        # an f32 jnp.mean over ~32k elements also carries O(1e-4)
        # summation error, visible in format-precision golden columns)
        import numpy as np
        g = self.grid
        nloc = tuple(s - 2 * self._g for s in self.fg.shape[1:])
        if nloc == (gs.nx, gs.ny, gs.nz):
            from ..core.grid import _axis_coords
            sh = [0.5 * d if ls else 0.0 for ls, d in
                  zip(gs.lshift_origin, (gs.dx, gs.dy, gs.dz))]
            x, _, _ = _axis_coords(gs.nx, gs.x0 + sh[0], gs.Lx,
                                   gs.periodic[0], gs.nghost,
                                   gs.grid_func[0], gs.grid_coeff[0],
                                   np.float64)
            y, _, _ = _axis_coords(gs.ny, gs.y0 + sh[1], gs.Ly,
                                   gs.periodic[1] or gs.lpole[1],
                                   gs.nghost, gs.grid_func[1],
                                   gs.grid_coeff[1], np.float64)
            x = x[gs.nghost:-gs.nghost]
            y = y[gs.nghost:-gs.nghost]
        else:
            # per-shard slab inside shard_map: local coordinates are
            # traced — fall back to jnp weights with mean-normalization
            # (the per-shard diag path is not used for format-precision
            # golden comparisons)
            if gs.coords == "cylindrical":
                w = g.xg + 0.0 * (g.yg + g.zg)
            elif gs.coords == "spherical":
                w = g.xg ** 2 * jnp.sin(g.yg) + 0.0 * g.zg
            else:
                w = jnp.ones((1, 1, 1), g.z.dtype)
            w = w * jnp.ones(nloc, w.dtype)
            for axis, (n, per) in enumerate(zip(nloc, gs.periodic)):
                if per or n == 1 or n != gs.shape[axis]:
                    continue    # edge halving only when axis is unsharded
                e = jnp.ones((n,), w.dtype).at[0].set(0.5).at[-1].set(0.5)
                shape = [1, 1, 1]
                shape[axis] = n
                w = w * e.reshape(shape)
            return w / jnp.mean(w)
        if gs.coords == "cartesian":
            w = np.ones((gs.nx, gs.ny, gs.nz))
        elif gs.coords == "cylindrical":
            w = np.broadcast_to(x[:, None, None],
                                (gs.nx, gs.ny, gs.nz)).copy()
        else:   # spherical: r² sinθ
            w = np.broadcast_to(
                (x ** 2)[:, None, None] * np.sin(y)[None, :, None],
                (gs.nx, gs.ny, gs.nz)).copy()
        # non-periodic axes: the boundary nodes own half a cell
        # (reference grid.f90:1169-1172 r2_weight/sinth_weight halving)
        for axis, (n, per) in enumerate(zip(gs.shape, gs.periodic)):
            if per or n == 1:
                continue
            e = np.ones(n)
            e[0] = e[-1] = 0.5
            shape = [1, 1, 1]
            shape[axis] = n
            w = w * e.reshape(shape)
        # normalize with the reference's ANALYTIC relative volume
        # (diagnostics.f90:147-199 dVol_rel1: e.g. spherical
        # (x1³−x0³)/(3dx)·(cosθ0−cosθ1)/dy·Lφ/dz), so sum-type means
        # equal fsum·dVol_rel1 exactly
        x0, x1 = gs.x0, gs.x0 + gs.Lx
        y0, y1 = gs.y0, gs.y0 + gs.Ly
        if gs.coords == "cylindrical":
            D = 1.0
            if gs.nx > 1:
                D *= (x1 ** 2 - x0 ** 2) / (2.0 * gs.dx)
            if gs.ny > 1:
                D *= gs.Ly / gs.dy
            if gs.nz > 1:
                D *= gs.Lz / gs.dz
        else:   # spherical
            D = 1.0
            if gs.nx > 1:
                D *= (x1 ** 3 - x0 ** 3) / (3.0 * gs.dx)
            if gs.ny > 1:
                D *= (np.cos(y0) - np.cos(y1)) / gs.dy
            if gs.nz > 1:
                D *= gs.Lz / gs.dz
        n_tot = gs.nx * gs.ny * gs.nz
        return jnp.asarray(w * (n_tot / D), g.z.dtype)

    def _gh(self, name):
        """Ghosted slab of a named field: (ncomp, mx, my, mz)."""
        return self.fg[self.reg.slice(name)]

    @_memo
    def _gh_only(self, name, axis):
        """Field slab ghosted ONLY along ``axis``: the other ghost axes are
        cropped BEFORE the stencil pass, so each stencil pass touches only
        the points it produces."""
        return interior(self._gh(name), _OTHER_AXES[axis],
                        g=self._g)

    @_memo
    def d(self, name, axis):
        """∂(field)/∂x_axis, interior, shape (ncomp, nx, ny, nz)."""
        out = st.der(self._gh_only(name, axis), axis, None, g=self._g)
        return out * self._inv(axis)

    @_memo
    def d2(self, name, axis):
        out = st.der2(self._gh_only(name, axis), axis, None, g=self._g)
        out = out * self._inv(axis) ** 2
        if (self.cfg is not None
                and self.cfg.grid.grid_func[axis] != "uniform"):
            # non-uniform-grid correction f'' → f''·ξ'² + f'·ξ'' uses the
            # COORDINATE first derivative.  For axes with h = 1 (any
            # cartesian axis; r and z in cylindrical; r in spherical)
            # pen.d IS the coordinate derivative, so the correction is
            # exact.  An angular stretched axis would need d/h removed
            # first — no reference sample does that.
            coords = self.cfg.grid.coords
            if ((coords == "cylindrical" and axis == 1)
                    or (coords == "spherical" and axis != 0)):
                raise NotImplementedError(
                    "stretched ANGULAR axis in curvilinear coordinates")
            tilde = (self.grid.dxt, self.grid.dyt, self.grid.dzt)[axis]
            out = out + tilde * self.d(name, axis)
        return out

    @_memo
    def d6_raw(self, name, axis):
        """Plain 6th difference Σc_k f_{i+k} (no Δ scaling) — hyperdiffusion
        'mesh' flavor (reference hyper3-mesh) and upwinding building block."""
        return st.der6(self._gh_only(name, axis), axis, None, g=self._g)

    @_memo
    def d5_raw(self, name, axis):
        """Plain 5th difference (no Δ scaling) — the uij5 building block
        of the reference 'hyper3-nu-const' viscosity (uij5glnrho)."""
        out = st.der5(self._gh_only(name, axis), axis, None)
        return out

    @_memo
    def _d_partial(self, name, axis):
        """First derivative reducing only ``axis`` (other axes ghosted) —
        shared by the mixed second derivatives."""
        return st._der_n(self._gh(name), axis, None, 1, 6, g=self._g)

    @_memo
    def dij(self, name, ax1, ax2):
        if ax1 == ax2:
            return self.d2(name, ax1)
        a, b = min(ax1, ax2), max(ax1, ax2)
        rest = tuple(set((0, 1, 2)) - {a, b})
        import os
        use_bidiag = (os.environ.get("PC_DERIJ", "bidiag") == "bidiag"
                      and self._g == 3)
        if use_bidiag and (self.cfg is None
                           or self.cfg.grid.coords == "cartesian"):
            # one-pass 12-point bidiagonal scheme — the reference default
            # (lbidiagonal_derij, deriv.f90:1376); pointwise metric factors
            # make it exact on stretched grids too (no x'' term in d²/didj)
            gh = interior(self._gh(name), rest, g=self._g)
            out = st.derij_bidiag(gh, a, b)
            return out * self._inv(a) * self._inv(b)
        out = st._der_n(self._d_partial(name, a), b, None, 1, 6, g=self._g)
        return interior(out, rest,
                        g=self._g) * self._inv(a) * self._inv(b)

    @_memo
    def grad(self, name):
        """(3, ncomp?, nx, ny, nz) gradient of a scalar field."""
        return jnp.stack([self.d(name, a)[0] for a in range(3)])

    @_memo
    def del2s(self, name):
        """Laplacian of a scalar field."""
        if self.cfg is not None and self.cfg.grid.coords != "cartesian":
            from .curvilinear import del2s_curv
            return del2s_curv(self, name)
        return sum(self.d2(name, a)[0] for a in range(3))

    @_memo
    def del2v(self, name):
        """Laplacian of a vector field: (3, nx, ny, nz)."""
        if self.cfg is not None and self.cfg.grid.coords != "cartesian":
            from .curvilinear import del2v_curv
            return del2v_curv(self, name)
        return sum(self.d2(name, a) for a in range(3))

    @_memo
    def del6s(self, name):
        """Unscaled Σ_a δ⁶_a f — hyperdiffusion operator (×Δ⁻⁶ applied by
        caller for 'simplified' flavor, or used as-is for mesh flavor)."""
        return sum(self.d6_raw(name, a)[0] for a in range(3))

    @_memo
    def del6v(self, name):
        return sum(self.d6_raw(name, a) for a in range(3))

    @_memo
    def del6v_scaled(self, name):
        """Σ_a ∂⁶f/∂x_a⁶ with physical Δ⁻⁶ scaling (hyper3 'simplified')."""
        return sum(self.d6_raw(name, a) * self._inv(a) ** 6 for a in range(3))

    @_memo
    def del6s_scaled(self, name):
        return sum(self.d6_raw(name, a)[0] * self._inv(a) ** 6 for a in range(3))

    @_memo
    def grad5divu(self):
        """(grad5divu)_i = Σ_j ∂⁵/∂x_i⁵ ∂u_j/∂x_j — the symmetric-hyper
        viscous cross term (reference hydro.f90:3148-3156 via der5i1j).
        i=j uses the direct 6th derivative; i≠j composes ∂⁵_i∘∂_j (the
        two axes have independent ghost budgets)."""
        uu_g = self._gh("uu")
        out = []
        for i_ in range(3):
            acc = self.d6_raw("uu", i_)[i_] * self._inv(i_) ** 6
            for j_ in range(3):
                if j_ == i_:
                    continue
                rest = tuple(set((0, 1, 2)) - {i_, j_})
                src = interior(uu_g[j_][None], rest,
                               g=self._g)
                t = st._der_n(src, i_, None, 5, 2, g=self._g)
                t = st._der_n(t, j_, None, 1, 6,
                              g=self._g)
                acc = acc + t[0] * self._inv(i_) ** 5 * self._inv(j_)
            out.append(acc)
        return jnp.stack(out)

    @_memo
    def field(self, name):
        """Interior values of a stored field: (ncomp, nx, ny, nz) / squeezed."""
        arr = interior(self._gh(name), (0, 1, 2), g=self._g)
        return arr[0] if self.reg.slots[name].ncomp == 1 else arr

    def ugrad(self, name, upwind=False):
        """u·∇f for a scalar field, optionally with 5th-order upwinding
        (reference der6_upwind / lupw_* flags): subtracts |u_a|·δ⁶f/(60Δ).
        Under FARGO the advecting velocity is the residual uu_advec
        (reference h_dot_grad(p%uu_advec, ...) in density/entropy)."""
        uu = self.uu_advec()
        out = sum(uu[a] * self.d(name, a)[0] for a in range(3))
        if upwind:
            out = out - sum(
                jnp.abs(uu[a]) * self.d6_raw(name, a)[0] * self._inv(a) / 60.0
                for a in range(3)
            )
        return out

    @_memo
    def uu_advec(self):
        """u with the FARGO mean azimuthal flow removed
        (hydro.f90:3176-3187); == uu when FARGO is off."""
        uu = self.uu()
        m = self._cache.get("_fargo_mean")
        if m is None:
            return uu
        return uu.at[1].add(-m)

    # ---- hydro ---------------------------------------------------------
    @_memo
    def uu(self):
        if "uu" not in self.reg.slots:
            kin = self.cfg.module("hydro_kinematic")
            if kin is not None:
                return kin.flow(self)
            z = jnp.zeros(self.fg.shape[-3:], self.fg.dtype)
            from ..ops.stencil import i as _interior
            zi = _interior(z[None], (0, 1, 2), g=self._g)[0]
            return jnp.stack([zi, zi, zi])
        return self.field("uu")

    @_memo
    def u2(self):
        uu = self.uu()
        return uu[0] ** 2 + uu[1] ** 2 + uu[2] ** 2

    @_memo
    def uij(self):
        """u_{i;j} = ∂u_i/∂x_j: (3, 3, nx, ny, nz)."""
        if "uu" not in self.reg.slots:
            kin = self.cfg.module("hydro_kinematic")
            if kin is not None:
                return kin.flow_uij(self)
            u = self.uu()
            return jnp.zeros((3,) + u.shape, u.dtype)
        return jnp.stack([self.d("uu", j) for j in range(3)], axis=1)

    @_memo
    def divu(self):
        uij = self.uij()
        if self.cfg.grid.coords != "cartesian":
            from .curvilinear import divu_curv
            return divu_curv(self, self.uu(), uij)
        return uij[0, 0] + uij[1, 1] + uij[2, 2]

    @_memo
    def oo(self):
        """Vorticity ∇×u."""
        uij = self.uij()
        if self.cfg.grid.coords != "cartesian":
            from .curvilinear import curl_curv
            return curl_curv(self, self.uu(), uij)
        return jnp.stack([
            uij[2, 1] - uij[1, 2],
            uij[0, 2] - uij[2, 0],
            uij[1, 0] - uij[0, 1],
        ])

    @_memo
    def sij(self):
        """Traceless rate-of-strain S_ij: (3, 3, nx, ny, nz), built
        component-wise."""
        uij = self.uij()
        div3 = self.divu() / 3.0
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                s = 0.5 * (uij[a, b] + uij[b, a])
                if a == b:
                    s = s - div3
                row.append(s)
            rows.append(jnp.stack(row))
        return jnp.stack(rows)

    @_memo
    def sij2(self):
        s = self.sij()
        return jnp.sum(s * s, axis=(0, 1))

    @_memo
    def ugu(self):
        """(u·∇)u: (3, nx, ny, nz) (+ curvature terms off-cartesian).
        Under FARGO the directional derivative uses uu_advec while the
        curvature terms keep the FULL u (hydro.f90:3193-3197
        uuadvec_guu)."""
        uu = self.uu()
        uij = self.uij()
        uadv = self.uu_advec()
        if self.cfg.grid.coords != "cartesian":
            from .curvilinear import ugu_curv
            return ugu_curv(self, uu, uij, uadv=uadv)
        return jnp.stack([
            sum(uadv[j] * uij[a, j] for j in range(3)) for a in range(3)
        ])

    @_memo
    def del2u(self):
        return self.del2v("uu")

    @_memo
    def dij_comp(self, name, comp, ax1, ax2):
        """Mixed second derivative of ONE component — avoids the 3×
        over-compute of dij() when only a single component is consumed
        (the graddiv pattern)."""
        if ax1 == ax2:
            return self.d2(name, ax1)[comp]
        a, b = min(ax1, ax2), max(ax1, ax2)
        rest = tuple(set((0, 1, 2)) - {a, b})
        gh = self._gh(name)[comp:comp + 1]
        if self._g == 3 and (self.cfg is None
                             or self.cfg.grid.coords == "cartesian"):
            gh_c = interior(gh, rest, g=self._g)
            out = st.derij_bidiag(gh_c, a, b)
            return (out * self._inv(a) * self._inv(b))[0]
        else:
            key = ("_dp1", name, comp, a)
            if key not in self._cache:
                self._cache[key] = st._der_n(gh, a, None, 1, 6, g=self._g)
            out = st._der_n(self._cache[key], b, None, 1, 6, g=self._g)
        return (interior(out, rest, g=self._g)
                * self._inv(a) * self._inv(b))[0]

    def _graddiv(self, name):
        """∇(∇·v) with single-component cross terms; the diagonal reuses
        the del2 second derivatives (reference del2v_etc GRADDIV)."""
        import os
        if os.environ.get("PC_GRADDIV", "comp") == "batch":
            return jnp.stack([
                sum(self.dij(name, a, j)[j] for j in range(3))
                for a in range(3)])
        out = []
        for a in range(3):
            acc = self.d2(name, a)[a]
            for j in range(3):
                if j != a:
                    acc = acc + self.dij_comp(name, j, a, j)
            out.append(acc)
        return jnp.stack(out)

    @_memo
    def graddivu(self):
        """∇(∇·u): (3, nx, ny, nz)."""
        return self._graddiv("uu")

    # ---- density (either lnρ or ρ slot: reference ldensity_nolog) ------
    @_memo
    def lnrho(self):
        if "rho" in self.reg.slots:
            return jnp.log(jnp.maximum(self.field("rho"), 1e-30))
        if "lnrho" not in self.reg.slots:
            # DENSITY=nodensity: ρ ≡ rho0 = 1 (reference nodensity.f90)
            any_name = next(iter(self.reg.slots))
            f = self.field(any_name)
            return jnp.zeros_like(f[0] if f.ndim == 4 else f)
        return self.field("lnrho")

    @_memo
    def glnrho(self):
        if "rho" in self.reg.slots:
            return self.grad("rho") * self.rho1()
        if "lnrho" not in self.reg.slots:
            # DENSITY=nodensity/boussinesq: ρ uniform → ∇lnρ = 0
            # (reference boussinesq.f90:214 p%glnrho=0)
            return jnp.zeros_like(self.uu()) if "uu" in self.reg.slots \
                else jnp.zeros((3,) + self.lnrho().shape, self.lnrho().dtype)
        return self.grad("lnrho")

    @_memo
    def del2lnrho(self):
        if "rho" in self.reg.slots:
            gl = self.glnrho()
            g2 = gl[0] ** 2 + gl[1] ** 2 + gl[2] ** 2
            return self.del2s("rho") * self.rho1() - g2
        return self.del2s("lnrho")

    @_memo
    def rho(self):
        if "rho" in self.reg.slots:
            return self.field("rho")
        return jnp.exp(self.lnrho())

    @_memo
    def rho1(self):
        if "rho" in self.reg.slots:
            return 1.0 / jnp.maximum(self.field("rho"), 1e-30)
        return jnp.exp(-self.lnrho())

    # ---- entropy / eos -------------------------------------------------
    @_memo
    def ss(self):
        return self.field("ss")

    @_memo
    def gss(self):
        return self.grad("ss")

    @_memo
    def del2ss(self):
        return self.del2s("ss")

    def get_cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @_memo
    def cs2(self):
        # delegated to the EOS slot (swappable closure: ideal gas, Saha
        # ionization, ... — reference select_eos_variable); EOS=noeos
        # leaves cs2=0 (reference noeos.f90 pencil defaults)
        if self.eos is None:
            if "uu" in self.reg.slots:
                return jnp.zeros_like(self.field("uu")[0])
            return jnp.zeros_like(self.field(next(iter(self.reg.slots)))[0])
        return self.eos.cs2(self)

    @_memo
    def lnTT(self):
        return self.eos.lnTT(self)

    @_memo
    def TT(self):
        if "TT" in self.reg.slots:
            return self.field("TT")
        return jnp.exp(self.lnTT())

    @_memo
    def TT1(self):
        if "TT" in self.reg.slots:
            return 1.0 / jnp.maximum(self.field("TT"), 1e-30)
        return jnp.exp(-self.lnTT())

    @_memo
    def glnTT(self):
        """∇lnT = γ∇s/cp + (γ−1)∇lnρ (ideal gas)."""
        e = self.eos
        if "eth" in self.reg.slots:
            # thermal_energy: lnT = ln(eth) − lnρ − ln(cv)
            eth = self.field("eth")
            return (self.grad("eth") / jnp.maximum(eth, 1e-30)
                    - self.glnrho())
        if "TT" in self.reg.slots:
            return self.grad("TT") * self.TT1()
        if "lnTT" in self.reg.slots:
            return self.grad("lnTT")
        out = (e.gamma - 1.0) * self.glnrho()
        if "ss" in self.reg.slots:
            out = out + (e.gamma / e.cp) * self.gss()
        return out

    @_memo
    def del2lnTT(self):
        e = self.eos
        if "lnTT" in self.reg.slots:
            return self.del2s("lnTT")
        out = (e.gamma - 1.0) * self.del2lnrho()
        if "ss" in self.reg.slots:
            out = out + (e.gamma / e.cp) * self.del2ss()
        return out

    @_memo
    def fpres(self):
        """−∇p/ρ for the ideal-gas EOS: −cs²(∇lnρ + ∇s/cp), or with lnTT
        evolved, −(cs²/γ)(∇lnρ + ∇lnT)."""
        if hasattr(self.eos, "fpres"):
            # EOS-owned pressure force (e.g. eos_temperature_ionization
            # rho1gpp with the Kippenhahn-Weigert δ, :459)
            return self.eos.fpres(self)
        cs2 = self.cs2()
        if "chem" in self.reg.slots and "lnTT" in self.reg.slots \
                and self.cfg is not None \
                and self.cfg.module("chemistry") is not None \
                and getattr(self.cfg.module("chemistry"), "mech",
                            None) is not None:
            # eos_chemistry (eos_chemistry.f90:581-585):
            # −∇p/ρ = −(p/ρ)(∇lnρ + ∇lnT + ∇μ⁻¹/μ⁻¹), p/ρ = R·μ⁻¹·T
            from .chemistry_chemkin import RGAS
            chem = self.cfg.module("chemistry")
            mech = chem.mech
            Ygh = self._gh("chem")
            W1 = jnp.asarray(1.0 / mech.mass)[:, None, None, None]
            mu1gh = jnp.sum(Ygh * W1, axis=0)
            gmu1 = chem._gradg(self, mu1gh)
            mu1 = jnp.sum(self.field("chem")
                          * jnp.asarray(1.0 / mech.mass)[:, None, None,
                                                         None], axis=0)
            p_rho = RGAS * mu1 * self.TT()
            return -p_rho[None] * (self.glnrho() + self.glnTT()
                                   + gmu1 / mu1[None])
        if "eth" in self.reg.slots:
            # thermal-energy slot: p = (γ−1)eth → −∇p/ρ
            gm1 = self.eos.gamma - 1.0
            return -gm1 * self.grad("eth") * self.rho1()
        if "TT" in self.reg.slots or "lnTT" in self.reg.slots:
            return -(cs2 / self.eos.gamma) * (self.glnrho() + self.glnTT())
        if hasattr(self.eos, "glnTT_profile"):
            # locally isothermal: fpres = −cs²(∇lnρ + ∇ln cs²)
            # (noentropy.f90:280, llocal_iso)
            return -cs2 * (self.glnrho() + self.eos.glnTT_profile(self))
        gl = self.glnrho()
        if "ss" in self.reg.slots:
            if hasattr(self.eos, "cp1tilde"):
                # ionization EOS: ∇p/ρ = cs²(∇lnρ + cp1tilde·∇s)
                # (eos_ionization.f90 pressure_gradient)
                gl = gl + self.eos.cp1tilde(self)[None] * self.gss()
            else:
                gl = gl + self.gss() / self.eos.cp
        den = self.cfg.module("density") if self.cfg is not None else None
        if den is not None and getattr(den, "lrelativistic_eos", False):
            # p = ρ/3 fluid: −∇p/(ρ+p) = −(3/4)cs²∇lnρ (noentropy.f90:287)
            return -0.75 * cs2 * gl
        return -cs2 * gl

    # ---- magnetic ------------------------------------------------------
    @_memo
    def aa(self):
        return self.field("aa")

    @_memo
    def aij(self):
        return jnp.stack([self.d("aa", j) for j in range(3)], axis=1)

    @_memo
    def bb(self):
        """B = ∇×A (+ optional uniform external field B_ext)."""
        aij = self.aij()
        if self.cfg.grid.coords != "cartesian":
            from .curvilinear import curl_curv
            return curl_curv(self, self.aa(), aij)
        bb = jnp.stack([
            aij[2, 1] - aij[1, 2],
            aij[0, 2] - aij[2, 0],
            aij[1, 0] - aij[0, 1],
        ])
        mag = self.cfg.module("magnetic")
        if mag is not None and any(b != 0.0 for b in mag.B_ext):
            bext = jnp.asarray(mag.B_ext, dtype=bb.dtype)[:, None, None, None]
            bb = bb + bext
        return bb

    @_memo
    def bij(self):
        """∂B_i/∂x_j from second derivatives of A (reference sub.f90
        ``bij_etc``): bij[i, j] = ε_{ikl} ∂_j ∂_k a_l."""
        def dja(k, a, b):
            return self.dij("aa", a, b)[k]
        out = [[None] * 3 for _ in range(3)]
        for j in range(3):
            out[0][j] = dja(2, 1, j) - dja(1, 2, j)
            out[1][j] = dja(0, 2, j) - dja(2, 0, j)
            out[2][j] = dja(1, 0, j) - dja(0, 1, j)
        return jnp.stack([jnp.stack(r) for r in out])

    @_memo
    def b2(self):
        bb = self.bb()
        return bb[0] ** 2 + bb[1] ** 2 + bb[2] ** 2

    @_memo
    def del2a(self):
        return self.del2v("aa")

    @_memo
    def diva(self):
        aij = self.aij()
        return aij[0, 0] + aij[1, 1] + aij[2, 2]

    @_memo
    def graddiva(self):
        return self._graddiv("aa")

    @property
    def mu0(self):
        """µ₀ in code units — 1 unless the run sets an inconsistent
        unit_magnetic (cdata: mu0 = mu0_SI·ρ_u·u_u²/B_u², e.g. the
        coronae SI samples run with µ₀ = 10⁹)."""
        mag = self.cfg.module("magnetic") if self.cfg is not None else None
        return getattr(mag, "mu0", 1.0) if mag is not None else 1.0

    def jj(self):
        """J = (∇×B)/µ₀ = (∇(∇·A) − ∇²A)/µ₀ (metric-aware expansions
        off-cartesian)."""
        if self.cfg.grid.coords != "cartesian":
            from .curvilinear import del2v_curv, graddiv_curv
            curlb = graddiv_curv(self, "aa") - del2v_curv(self, "aa")
        else:
            curlb = self.graddiva() - self.del2a()
        m = self.mu0
        return curlb if m == 1.0 else curlb / m
    jj = _memo(jj)

    @_memo
    def j2(self):
        jj = self.jj()
        return jj[0] ** 2 + jj[1] ** 2 + jj[2] ** 2

    @_memo
    def uxb(self):
        uu, bb = self.uu(), self.bb()
        return jnp.stack([
            uu[1] * bb[2] - uu[2] * bb[1],
            uu[2] * bb[0] - uu[0] * bb[2],
            uu[0] * bb[1] - uu[1] * bb[0],
        ])

    @_memo
    def jxb(self):
        jj, bb = self.jj(), self.bb()
        return jnp.stack([
            jj[1] * bb[2] - jj[2] * bb[1],
            jj[2] * bb[0] - jj[0] * bb[2],
            jj[0] * bb[1] - jj[1] * bb[0],
        ])

    @_memo
    def jxbr(self):
        return self.jxb() * self.rho1()

    @_memo
    def va2(self):
        return self.b2() * self.rho1() / self.mu0
