"""Field-line tracing (reference ``src/streamlines.f90`` trace_streamlines
+ the tracer/fixed-point analysis of ``src/fixed_points.f90``): integrate
dx/ds = B/|B| from seed points through the periodic box.

JAX-native design: the reference traces lines one at a time per core with
adaptive RK5 and MPI hand-off at processor boundaries; here ALL seeds
advance together in a single ``lax.scan`` of fixed-step RK4 with periodic
trilinear interpolation — one (nseeds, 3) tensor op per step, no
communication (the interpolation gather is local under jit).

Tracer maps: seeds on the z0 plane integrated until they cross the top
boundary give the footpoint mapping F(x0, y0) → (x1, y1); fixed points of
the Poincaré map (|F(x)−x| minima) locate null-separatrix structures as
in the reference's fixed_points module.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _interp_periodic(field, pos, lo, L):
    """Trilinear periodic interpolation of (3, nx, ny, nz) at (ns, 3)."""
    n = jnp.asarray(field.shape[1:])
    u = (pos - lo) / L * n                 # grid units, cell-centered 0..n
    i0 = jnp.floor(u - 0.5).astype(jnp.int32)
    w = u - 0.5 - i0
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = (i0 + jnp.asarray([dx, dy, dz])) % n
                wgt = (jnp.where(dx, w[:, 0], 1 - w[:, 0])
                       * jnp.where(dy, w[:, 1], 1 - w[:, 1])
                       * jnp.where(dz, w[:, 2], 1 - w[:, 2]))
                out = out + wgt[None, :] * field[:, idx[:, 0], idx[:, 1],
                                                 idx[:, 2]]
    return out.T                           # (ns, 3)


def trace_streamlines(field, seeds, spec, ds=None, nsteps=512,
                      direction=1.0):
    """Integrate dx/ds = ±B̂ with fixed-step RK4 for all seeds at once.

    field: (3, nx, ny, nz) interior vector field; seeds: (ns, 3).
    Returns the (nsteps+1, ns, 3) path (positions NOT wrapped, so crossing
    counts are recoverable)."""
    lo = jnp.asarray([spec.x0, spec.y0, spec.z0], seeds.dtype)
    L = jnp.asarray([spec.Lx, spec.Ly, spec.Lz], seeds.dtype)
    if ds is None:
        ds = float(min(spec.Lx / spec.nx, spec.Ly / spec.ny,
                       spec.Lz / spec.nz))

    def bhat(pos):
        b = _interp_periodic(field, pos, lo, L)
        return direction * b / jnp.maximum(
            jnp.sqrt(jnp.sum(b * b, axis=1, keepdims=True)), 1e-30)

    def step(pos, _):
        k1 = bhat(pos)
        k2 = bhat(pos + 0.5 * ds * k1)
        k3 = bhat(pos + 0.5 * ds * k2)
        k4 = bhat(pos + ds * k3)
        new = pos + (ds / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return new, new

    _, path = jax.lax.scan(step, seeds, None, length=nsteps)
    return jnp.concatenate([seeds[None], path], axis=0)


def tracer_map(field, spec, nseed=16, nsteps=4096):
    """Footpoint map of the z0 → z1 field-line mapping (reference tracers):
    seeds on an (nseed × nseed) grid of the bottom plane, each traced until
    its (unwrapped) z exceeds z0+Lz; returns (seeds_xy, endpoints_xy)."""
    xs = spec.x0 + (np.arange(nseed) + 0.5) * spec.Lx / nseed
    ys = spec.y0 + (np.arange(nseed) + 0.5) * spec.Ly / nseed
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    seeds = jnp.asarray(
        np.stack([gx.ravel(), gy.ravel(),
                  np.full(nseed * nseed, spec.z0 + 1e-6)], axis=1),
        jnp.asarray(field).dtype)
    path = trace_streamlines(field, seeds, spec, nsteps=nsteps)
    z = path[:, :, 2]
    crossed = z >= spec.z0 + spec.Lz
    # first index where the line crossed the top (or last step)
    icross = jnp.argmax(crossed, axis=0)
    icross = jnp.where(jnp.any(crossed, axis=0), icross, path.shape[0] - 1)
    idx = icross[None, :, None].repeat(3, axis=2)
    p_hi = jnp.take_along_axis(path, idx, axis=0)[0]
    p_lo = jnp.take_along_axis(path, jnp.maximum(idx - 1, 0), axis=0)[0]
    # linear interpolation of the exact top-plane crossing
    ztop = spec.z0 + spec.Lz
    frac = jnp.clip((ztop - p_lo[:, 2])
                    / jnp.maximum(p_hi[:, 2] - p_lo[:, 2], 1e-30), 0.0, 1.0)
    end = p_lo + frac[:, None] * (p_hi - p_lo)
    return seeds[:, :2], end[:, :2]


def fixed_points(seeds_xy, end_xy, spec, tol=None):
    """Poincaré-map fixed points: seed cells whose footpoint displacement
    (periodic-wrapped in x, y) is a local minimum below tol (default half
    a seed-grid spacing) — the reference fixed_points.f90 criterion."""
    L = np.asarray([spec.Lx, spec.Ly])
    d = np.asarray(end_xy) - np.asarray(seeds_xy)
    d = d - L * np.round(d / L)
    dist = np.sqrt((d ** 2).sum(axis=1))
    n = int(round(np.sqrt(len(dist))))
    if tol is None:
        tol = 0.5 * min(spec.Lx, spec.Ly) / n
    return np.asarray(seeds_xy)[dist < tol], dist
