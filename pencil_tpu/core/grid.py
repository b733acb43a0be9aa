"""Grid construction: coordinates + spacing metrics.

JAX-native analog of reference ``src/grid.f90:59-866`` (``construct_grid``).
The Grid object is a pytree of arrays (1-D ghosted coordinate vectors and
inverse-spacing metric vectors) so it can be passed through ``jax.jit`` /
``shard_map`` and sliced per shard exactly like the field data.

Derivatives on non-equidistant grids follow the coordinate-transform rule
used by the reference (``src/deriv.f90:89-171``): with x = x(ξ) and uniform
ξ, ∂f/∂x = x'(ξ)⁻¹ ∂f/∂ξ, so we store ``dx_1 = 1/x'`` and
``dx_tilde = -x''/x'²`` (for second derivatives).  Uniform grids store
constant vectors.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .config import GridSpec


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Grid:
    # Ghosted 1-D coordinate vectors: shapes (mx,), (my,), (mz,)
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    # Inverse grid spacing (ghosted 1-D): 1/x'(ξ) etc.
    dx_1: jnp.ndarray
    dy_1: jnp.ndarray
    dz_1: jnp.ndarray
    # Nonuniformity metric -x''/x'^2 (ghosted 1-D); zero for uniform grids.
    dx_tilde: jnp.ndarray
    dy_tilde: jnp.ndarray
    dz_tilde: jnp.ndarray
    # ghost width (static aux data: 3 → 6th order, 4 → 8th, 5 → 10th)
    ng: int = field(default=3, metadata=dict(static=True))

    @property
    def nghost(self) -> int:
        return self.ng

    def interior(self, vec: jnp.ndarray) -> jnp.ndarray:
        g = self.nghost
        return vec[g:-g]

    # Interior coordinate fields broadcast to (nx, ny, nz)
    @property
    def xg(self) -> jnp.ndarray:
        return self.interior(self.x)[:, None, None]

    @property
    def yg(self) -> jnp.ndarray:
        return self.interior(self.y)[None, :, None]

    @property
    def zg(self) -> jnp.ndarray:
        return self.interior(self.z)[None, None, :]

    # Interior inverse spacings broadcast for derivative scaling
    @property
    def dx1(self) -> jnp.ndarray:
        return self.interior(self.dx_1)[:, None, None]

    @property
    def dy1(self) -> jnp.ndarray:
        return self.interior(self.dy_1)[None, :, None]

    @property
    def dz1(self) -> jnp.ndarray:
        return self.interior(self.dz_1)[None, None, :]

    @property
    def dxmin(self) -> jnp.ndarray:
        return 1.0 / jnp.maximum(
            jnp.max(self.dx_1), jnp.maximum(jnp.max(self.dy_1), jnp.max(self.dz_1))
        )

    def dline_1(self):
        """Per-axis inverse line elements broadcast over the box — the
        reference's ``dline_1`` (used by advective CFL, src/hydro.f90:3803)."""
        return (self.dx1, self.dy1, self.dz1)

    # nonuniformity metric, interior broadcast
    @property
    def dxt(self):
        return self.interior(self.dx_tilde)[:, None, None]

    @property
    def dyt(self):
        return self.interior(self.dy_tilde)[None, :, None]

    @property
    def dzt(self):
        return self.interior(self.dz_tilde)[None, None, :]


def _axis_coords(n: int, x0: float, L: float, periodic: bool, nghost: int,
                 func: str, coeff: float, dtype, step=(), star=None):
    """Ghosted coordinates + metrics for one axis.

    Non-equidistant functions follow the reference (src/grid.f90 grid_func
    :441,637,824): x(ξ) with uniform ξ ∈ [0, 1]; stored metrics are
    dx_1 = 1/x'(ξ̂) and dx_tilde = −x''/x'² (per unit ξ̂ = grid index), the
    exact factors the der/der2 coordinate-transform rule needs.
      'uniform':  x = x0 + L·ξ
      'sinh':     clustering toward the centre, coeff = a:
                  x = x0 + L·(sinh(a(ξ−½))/(2 sinh(a/2)) + ½)
    """
    m = n + 2 * nghost
    if n == 1:
        # degenerate dimension: centered coordinate, ZERO inverse metric
        # (reference src/grid.f90 "if (nxgrid==1) ... dx_1 = 0"), so the
        # axis contributes nothing to derivatives or CFL sums
        coords = np.full((m,), x0 + 0.5 * L)
        return (np.asarray(coords, dtype), np.zeros((m,), dtype),
                np.zeros((m,), dtype))
    if periodic:
        dxi = 1.0 / n
        # periodic axes are cell-centered — the reference ALWAYS half-cell
        # shifts them (``if (lperi) xi = xi + 0.5``, src/grid.f90:141), so
        # the first point sits at x0 + dx/2, never on x0
        xi = dxi * (np.arange(-nghost, n + nghost) + 0.5)
    else:
        dxi = 1.0 / max(n - 1, 1)
        xi = dxi * np.arange(-nghost, n + nghost)   # node-centered

    if func == "uniform":
        coords = x0 + L * xi
        d1 = np.full((m,), 1.0 / (L * dxi))
        dt_ = np.zeros((m,))
    elif func == "sinh":
        # reference parameterization (grid.f90:209-221): the sinh argument
        # scale is a = coeff_grid·dx per INDEX, i.e. coeff·L per unit
        # ξ ∈ [0,1]; the inflection point ξ* solves find_star for the
        # clustering location x_star (xyz_star, default 0 — grid.f90:211)
        a = (coeff if coeff else 2.0) * L
        x_star = star if star is not None else 0.0
        x_lo, x_up = x0, x0 + L
        xi_lo, xi_up = 0.0, 1.0
        xs = 0.5 * (xi_lo + xi_up)
        for _ in range(100):                    # find_star Newton
            glo, glo_d = np.sinh(a * (xi_lo - xs)), a * np.cosh(
                a * (xi_lo - xs))
            gup, gup_d = np.sinh(a * (xi_up - xs)), a * np.cosh(
                a * (xi_up - xs))
            fval = -(x_up - x_star) * glo + (x_lo - x_star) * gup
            fder = (x_up - x_star) * glo_d - (x_lo - x_star) * gup_d
            step_ = fval / fder
            xs = xs - step_
            if abs(step_) < 1e-14:
                break
        g = np.sinh(a * (xi - xs))
        glo = np.sinh(a * (xi_lo - xs))
        gup = np.sinh(a * (xi_up - xs))
        den = gup - glo
        coords = x0 + L * (g - glo) / den
        xp = L * a * np.cosh(a * (xi - xs)) / den           # dx/dξ
        xpp = L * a * a * np.sinh(a * (xi - xs)) / den      # d²x/dξ²
        d1 = 1.0 / (xp * dxi)                               # per grid index
        # tilde = −x_jj/x_j² with j the unit grid index: the dξ factors
        # cancel to −x''(ξ)/x'(ξ)²  (see der2 coordinate-transform rule)
        dt_ = -xpp / (xp * xp)
    elif func == "power-law":
        # d[x^c] = const (src/grid.f90:356-385 with grid_profile
        # g=ξ̃^(1/c), :2080): u(ξ) = x0^c + (x1^c − x0^c)·ξ, x = u^(1/c)
        c = coeff
        if not c:
            raise ValueError("grid_func='power-law' needs coeff_grid")
        x1 = x0 + L
        u0, u1 = x0 ** c, x1 ** c
        u = u0 + (u1 - u0) * xi
        coords = u ** (1.0 / c)
        xp = (1.0 / c) * u ** (1.0 / c - 1.0) * (u1 - u0)
        xpp = (1.0 / c) * (1.0 / c - 1.0) * u ** (1.0 / c - 2.0) \
            * (u1 - u0) ** 2
        d1 = 1.0 / (xp * dxi)
        dt_ = -xpp / (xp * xp)
    elif func in ("log", "logarithmic"):
        # d[ln x] = const (src/grid.f90 'log'): x = x0·(x1/x0)^ξ
        x1 = x0 + L
        lr = np.log(x1 / x0)
        coords = x0 * np.exp(lr * xi)
        xp = coords * lr
        d1 = 1.0 / (xp * dxi)
        dt_ = -lr * lr * coords / (xp * xp)
    elif func == "step-linear":
        # three linear zones with tanh-smoothed transitions
        # (src/grid.f90:262/579/737 + grid_profile :2131-2170): the grid
        # index ξ̂ runs 0..n−1; spacing dxyz(k) in each zone chosen so the
        # steps land at xyz_step with index fractions xi_step_frac
        if not step:
            raise ValueError("grid_func='step-linear' needs xyz_step/"
                             "xi_step_frac/xi_step_width")
        xs1, xs2, fr1, fr2, w1, w2 = step
        nn = n - 1.0
        xi1, xi2 = fr1 * nn, fr2 * nn
        x1 = x0 + L
        dz1_ = (xs1 - x0) / (xi1 - 0.0) if xi1 != 0.0 else 0.0
        dz2_ = (xs2 - xs1) / (xi2 - xi1)
        dz3_ = (x1 - xs2) / (nn - xi2)
        xh = xi * (1.0 / dxi)            # back to index space ξ̂

        def _g(xh):
            lc1 = np.log(np.cosh((xh - xi1) / w1)) if xi1 != 0.0 else 0.0
            lc2 = np.log(np.cosh((xh - xi2) / w2))
            if xi1 != 0.0:
                return (dz1_ * 0.5 * (xh - w1 * lc1)
                        + dz2_ * 0.5 * (w1 * lc1 - w2 * lc2)
                        + dz3_ * 0.5 * (xh + w2 * lc2))
            return (dz2_ * 0.5 * (xh - w2 * lc2)
                    + dz3_ * 0.5 * (xh + w2 * lc2))

        t1 = np.tanh((xh - xi1) / w1) if xi1 != 0.0 else 0.0
        t2 = np.tanh((xh - xi2) / w2)
        if xi1 != 0.0:
            gd1 = (dz1_ * 0.5 * (1.0 - t1) + dz2_ * 0.5 * (t1 - t2)
                   + dz3_ * 0.5 * (1.0 + t2))
            gd2 = (0.5 / w1 * (dz2_ - dz1_) / np.cosh((xh - xi1) / w1) ** 2
                   + 0.5 / w2 * (dz3_ - dz2_) / np.cosh((xh - xi2) / w2) ** 2)
        else:
            gd1 = dz2_ * 0.5 * (1.0 - t2) + dz3_ * 0.5 * (1.0 + t2)
            gd2 = 0.5 / w2 * (dz3_ - dz2_) / np.cosh((xh - xi2) / w2) ** 2
        coords = x0 + _g(xh) - _g(np.array(0.0))
        d1 = 1.0 / gd1                  # gder1 is already per grid index
        dt_ = -gd2 / (gd1 * gd1)
    else:
        raise NotImplementedError(f"grid_func={func!r}")
    return (np.asarray(coords, dtype), np.asarray(d1, dtype),
            np.asarray(dt_, dtype))


def make_grid(spec: GridSpec, dtype=jnp.float32) -> Grid:
    npdtype = np.dtype(jnp.dtype(dtype).name)
    sh = [0.5 * d if ls else 0.0 for ls, d in
          zip(spec.lshift_origin, (spec.dx, spec.dy, spec.dz))]
    x, dx1, dxt = _axis_coords(spec.nx, spec.x0 + sh[0], spec.Lx, spec.periodic[0],
                               spec.nghost, spec.grid_func[0], spec.grid_coeff[0], npdtype,
                               spec.grid_step[0], spec.xyz_star[0])
    y, dy1, dyt = _axis_coords(spec.ny, spec.y0 + sh[1], spec.Ly,
                               spec.periodic[1] or spec.lpole[1],
                               spec.nghost, spec.grid_func[1], spec.grid_coeff[1], npdtype,
                               spec.grid_step[1], spec.xyz_star[1])
    z, dz1, dzt = _axis_coords(spec.nz, spec.z0 + sh[2], spec.Lz, spec.periodic[2],
                               spec.nghost, spec.grid_func[2], spec.grid_coeff[2], npdtype,
                               spec.grid_step[2], spec.xyz_star[2])
    return Grid(
        x=jnp.asarray(x), y=jnp.asarray(y), z=jnp.asarray(z),
        dx_1=jnp.asarray(dx1), dy_1=jnp.asarray(dy1), dz_1=jnp.asarray(dz1),
        dx_tilde=jnp.asarray(dxt), dy_tilde=jnp.asarray(dyt), dz_tilde=jnp.asarray(dzt),
        ng=spec.nghost,
    )


def local_grid(grid: Grid, spec: GridSpec, shard_idx, shard_counts) -> Grid:
    """Slice a global Grid down to one shard's local (ghosted) grid.

    shard_idx / shard_counts are per-axis (ix, iy, iz) ints or traced values.
    Local interiors are contiguous global slices; ghosted vectors overlap
    neighbours by nghost (the coordinate values there are the true global
    coordinates, which is what one-sided BC stencils need).
    """
    g = spec.nghost

    def sl(vec, n_global, idx, cnt):
        nloc = n_global // cnt
        start = idx * nloc
        return jax.lax.dynamic_slice_in_dim(vec, start, nloc + 2 * g)

    return Grid(
        x=sl(grid.x, spec.nx, shard_idx[0], shard_counts[0]),
        y=sl(grid.y, spec.ny, shard_idx[1], shard_counts[1]),
        z=sl(grid.z, spec.nz, shard_idx[2], shard_counts[2]),
        dx_1=sl(grid.dx_1, spec.nx, shard_idx[0], shard_counts[0]),
        dy_1=sl(grid.dy_1, spec.ny, shard_idx[1], shard_counts[1]),
        dz_1=sl(grid.dz_1, spec.nz, shard_idx[2], shard_counts[2]),
        ng=g,
        dx_tilde=sl(grid.dx_tilde, spec.nx, shard_idx[0], shard_counts[0]),
        dy_tilde=sl(grid.dy_tilde, spec.ny, shard_idx[1], shard_counts[1]),
        dz_tilde=sl(grid.dz_tilde, spec.nz, shard_idx[2], shard_counts[2]),
    )
