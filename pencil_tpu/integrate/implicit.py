"""Operator-split implicit diffusion (reference ``src/implicit_physics.f90``
``calc_heatcond_ADI`` called at src/run.f90:715: alternating-direction
tridiagonal solves for heat conduction stiffer than the explicit CFL).

JAX-native: per axis, solve (I − Δt·χ ∂²_a) f = f sequentially
(Douglas–Gunn splitting, 1st-order in the splitting, unconditionally
stable).  Periodic axes solve exactly in Fourier space (diagonal there);
non-periodic axes use ``jax.lax.linalg.tridiagonal_solve`` with
zero-gradient boundary rows."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _solve_axis_periodic(f, chi_dt, n, d, axis):
    k = 2 * np.pi * np.fft.fftfreq(n, d=d)
    k2 = jnp.asarray(k * k, jnp.float32)
    shape = [1] * f.ndim
    shape[axis] = n
    fk = jnp.fft.fft(f, axis=axis)
    fk = fk / (1.0 + chi_dt * k2.reshape(shape))
    return jnp.real(jnp.fft.ifft(fk, axis=axis)).astype(f.dtype)


def _solve_axis_tridiag(f, chi_dt, n, d, axis):
    """(I − Δt·χ·D2) x = f with 2nd-order D2 and zero-flux boundaries."""
    r = chi_dt / (d * d)
    dl = jnp.full((n,), -r, jnp.float32).at[0].set(0.0)
    du = jnp.full((n,), -r, jnp.float32).at[n - 1].set(0.0)
    diag = jnp.full((n,), 1.0 + 2.0 * r, jnp.float32)
    # zero-gradient: ghost = first interior → boundary rows see only one
    # neighbour with weight r
    diag = diag.at[0].set(1.0 + r).at[n - 1].set(1.0 + r)
    fm = jnp.moveaxis(f, axis, 0).astype(jnp.float32)
    sh = fm.shape
    b = fm.reshape(n, -1)
    x = jax.lax.linalg.tridiagonal_solve(dl, diag, du, b)
    return jnp.moveaxis(x.reshape(sh), 0, axis).astype(f.dtype)


def _cyclic_tridiag(dl, d, du, b):
    """Periodic tridiagonal solve via Sherman–Morrison: corners
    M[0,n-1] = dl[0], M[n-1,0] = du[n-1] on top of tridiag(dl, d, du).
    b: (n, k)."""
    n = d.shape[0]
    beta = dl[0]
    alpha = du[n - 1]
    gamma = -d[0]
    d2 = d.at[0].add(-gamma).at[n - 1].add(-alpha * beta / gamma)
    dl2 = dl.at[0].set(0.0)
    du2 = du.at[n - 1].set(0.0)
    y = jax.lax.linalg.tridiagonal_solve(dl2, d2, du2, b)
    u = jnp.zeros((n, 1), d.dtype).at[0, 0].set(gamma).at[n - 1, 0].set(
        alpha)
    q = jax.lax.linalg.tridiagonal_solve(dl2, d2, du2, u)
    vy = y[0] + (beta / gamma) * y[n - 1]         # (k,)
    vq = q[0, 0] + (beta / gamma) * q[n - 1, 0]   # scalar
    return y - q * (vy / (1.0 + vq))[None, :]


def sweep_nonuniform(field, dc_dt, d1, dtil, periodic, axis):
    """One implicit sweep (I − Δt·L_a) x = field with the reference's
    nonuniform 2nd-order operator (implicit_diffusion.f90:306-360
    set_diffusion_equations):
        lo_i = ½·dc·d1·(d1 − ½·d̃),  di = −dc·d1²,
        up_i = ½·dc·d1·(d1 + ½·d̃)
    Periodic axes use a cyclic (Sherman–Morrison) tridiagonal solve;
    non-periodic axes get zero-gradient boundary rows."""
    f64 = jnp.float64 if field.dtype == jnp.float64 else jnp.float32
    d1 = d1.astype(f64)
    dtil = dtil.astype(f64)
    n = d1.shape[0]
    lo = 0.5 * dc_dt * d1 * (d1 - 0.5 * dtil)
    di = -dc_dt * d1 * d1
    up = 0.5 * dc_dt * d1 * (d1 + 0.5 * dtil)
    fm = jnp.moveaxis(field, axis, 0).astype(f64)
    sh = fm.shape
    q = fm.reshape(n, -1)
    # Crank–Nicolson (implicit_pencil :396-460): rhs = (I + A)q, solve
    # (I − A)x = rhs with A = tridiag(lo, di, up) (+ periodic wrap)
    qm = jnp.roll(q, 1, axis=0)
    qp = jnp.roll(q, -1, axis=0)
    if not periodic:
        # zero-gradient ghost: q_{-1} = q_0, q_{n} = q_{n-1}
        qm = qm.at[0].set(q[0])
        qp = qp.at[n - 1].set(q[n - 1])
    rhs = lo[:, None] * qm + (1.0 + di)[:, None] * q + up[:, None] * qp
    dl = -lo
    dd = 1.0 - di
    du = -up
    if periodic:
        x = _cyclic_tridiag(dl, dd, du, rhs)
    else:
        dl2 = dl.at[0].set(0.0)
        du2 = du.at[n - 1].set(0.0)
        dd2 = dd.at[0].add(dl[0]).at[n - 1].add(du[n - 1])
        x = jax.lax.linalg.tridiagonal_solve(dl2, dd2, du2, rhs)
    return jnp.moveaxis(x.reshape(sh), 0, axis).astype(field.dtype)


def integrate_diffusion_full(field, dc, dt, grid, spec):
    """Reference integrate_diffusion_full (implicit_diffusion.f90:106-161):
    symmetric dimensional splitting — x, y, z sweeps then z, y, x sweeps,
    each over Δt/2.  ``field``: (..., nx, ny, nz) interior array."""
    dth = 0.5 * dt
    axes = []
    metrics = ((grid.interior(grid.dx_1), grid.interior(grid.dx_tilde)),
               (grid.interior(grid.dy_1), grid.interior(grid.dy_tilde)),
               (grid.interior(grid.dz_1), grid.interior(grid.dz_tilde)))
    for a in range(3):
        if spec.shape[a] > 1:
            axes.append(a)
    out = field
    for a in axes + axes[::-1]:
        d1, dtil = metrics[a]
        out = sweep_nonuniform(out, dc * dth, d1, dtil,
                               spec.periodic[a], field.ndim - 3 + a)
    return out


def adi_diffuse(field, chi_dt, spec):
    """Implicitly diffuse one interior scalar field by Δt·χ (split per
    axis)."""
    out = field
    for axis, (n, d, per) in enumerate(zip(
            spec.shape, (spec.dx, spec.dy, spec.dz), spec.periodic)):
        ax = field.ndim - 3 + axis
        if per:
            out = _solve_axis_periodic(out, chi_dt, n, d, ax)
        else:
            out = _solve_axis_tridiag(out, chi_dt, n, d, ax)
    return out
