"""Grid↔particle mapping (reference ``src/particles_map.f90``: NGP/CIC/TSC
selection at :54-90, interpolation of gas quantities to particles and
deposition of particle fields to the grid).

JAX-native: interpolation = vectorized gather from the *ghosted* gas stack
(ghost zones make periodic wrap free); deposition = scatter-add onto a
ghosted accumulator followed by a ghost-fold (the adjoint of the periodic
ghost fill).  All shapes static; indices clipped to the ghosted extents.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.stencil import NGHOST


def _cell_coords(xp, spec, dtype, origin=None):
    """Fractional cell coordinates of particles relative to the ghosted
    array origin.  xp: (npar, 3) positions; ``origin`` overrides the box
    corner for per-shard local frames."""
    g = NGHOST
    if origin is None:
        x0 = jnp.asarray([spec.x0, spec.y0, spec.z0], dtype)
    else:
        x0 = origin
    d = jnp.asarray([spec.dx, spec.dy, spec.dz], dtype)
    # PERIODIC axes always carry the half-cell origin shift (grid.f90:141
    # ``if (lperi) xi = xi + 0.5``): interior node i sits at
    # x0 + (i + 1/2)·dx; non-periodic axes put node 0 exactly at x0
    # unless lshift_origin asks for cell centres
    sh = jnp.asarray([0.5 * dd if (per or ls) else 0.0
                      for per, ls, dd in
                      zip(spec.periodic, spec.lshift_origin,
                          (spec.dx, spec.dy, spec.dz))],
                     dtype)
    return (xp - x0 - sh) / d + g


def _tsc_weights(fc):
    """Triangular-shaped-cloud weights over 3 points per axis.

    fc: fractional coordinate; returns (idx0, (w0, w1, w2)) with idx0 the
    lowest of the 3 contributing grid indices."""
    i_near = jnp.floor(fc + 0.5).astype(jnp.int32)  # nearest grid point
    d = fc - i_near.astype(fc.dtype)                # in [-1/2, 1/2]
    w0 = 0.5 * (0.5 - d) ** 2
    w1 = 0.75 - d * d
    w2 = 0.5 * (0.5 + d) ** 2
    return i_near - 1, (w0, w1, w2)


def _cic_weights(fc):
    i0 = jnp.floor(fc).astype(jnp.int32)
    d = fc - i0.astype(fc.dtype)
    return i0, (1.0 - d, d)


def interpolate(fields, xp, spec, scheme="tsc", origin=None, mask=None):
    """Gather gas values at particle positions.

    fields: ghosted (nc, mx, my, mz); xp: (npar, 3); returns (nc, npar).
    With ``origin``/``mask`` (sharded mode) the gather is in the shard's
    local frame, indices are clipped, and non-owned particles zeroed —
    psum over the mesh then reconstructs every particle's value."""
    fc = _cell_coords(xp, spec, fields.dtype, origin)
    if scheme == "tsc":
        i0, wx = _tsc_weights(fc[:, 0])
        j0, wy = _tsc_weights(fc[:, 1])
        k0, wz = _tsc_weights(fc[:, 2])
    elif scheme == "cic":
        i0, wx = _cic_weights(fc[:, 0])
        j0, wy = _cic_weights(fc[:, 1])
        k0, wz = _cic_weights(fc[:, 2])
    elif scheme == "ngp":
        idx = jnp.rint(fc).astype(jnp.int32)
        return fields[:, idx[:, 0], idx[:, 1], idx[:, 2]]
    else:
        raise ValueError(scheme)
    mx_, my_, mz_ = fields.shape[1:]
    if mask is not None:
        i0 = jnp.clip(i0, 0, mx_ - 3)
        j0 = jnp.clip(j0, 0, my_ - 3)
        k0 = jnp.clip(k0, 0, mz_ - 3)
    # ONE combined gather for all K³ cloud cells instead of 27 separate
    # gathers, then the weighted reduction
    Ka, Kb, Kc = len(wx), len(wy), len(wz)
    flat0 = (i0 * my_ + j0) * mz_ + k0
    ff = fields.reshape(fields.shape[0], -1)
    idx = []
    ws = []
    for a in range(Ka):
        for b in range(Kb):
            for c in range(Kc):
                idx.append(flat0 + (a * my_ + b) * mz_ + c)
                ws.append(wx[a] * wy[b] * wz[c])
    gathered = ff[:, jnp.stack(idx)]          # (nc, K, npar)
    w = jnp.stack(ws)                          # (K, npar)
    out = jnp.sum(gathered * w[None], axis=1)
    if mask is not None:
        out = out * mask[None, :]
    return out


def deposit(values, xp, spec, shape, scheme="tsc", dtype=jnp.float32,
            origin=None, mask=None, mesh_axis_names=None,
            mesh_shape=(1, 1, 1), shear_dy=None):
    """Scatter particle values onto the grid (ghosted accumulate + fold).

    values: (npar,) or (nc, npar); returns interior (nc?, nx, ny, nz) with
    the particle quantity *density* (sum of value·weight per cell).
    Sharded mode (origin/mask given): deposit into the local ghosted block
    and ship ghost-zone spill to the owning neighbours (reverse halo)."""
    g = NGHOST
    squeeze = values.ndim == 1
    if squeeze:
        values = values[None]
    if mask is not None:
        values = values * mask[None, :]
    nc = values.shape[0]
    mx, my, mz = shape[0] + 2 * g, shape[1] + 2 * g, shape[2] + 2 * g
    acc = jnp.zeros((nc, mx, my, mz), dtype)
    fc = _cell_coords(xp, spec, dtype, origin)
    if scheme == "tsc":
        i0, wx = _tsc_weights(fc[:, 0])
        j0, wy = _tsc_weights(fc[:, 1])
        k0, wz = _tsc_weights(fc[:, 2])
    elif scheme == "cic":
        i0, wx = _cic_weights(fc[:, 0])
        j0, wy = _cic_weights(fc[:, 1])
        k0, wz = _cic_weights(fc[:, 2])
    else:
        idx = jnp.rint(fc).astype(jnp.int32)
        if mask is not None:
            idx = jnp.clip(idx, 0, jnp.asarray([mx - 1, my - 1, mz - 1]))
        acc = acc.at[:, idx[:, 0], idx[:, 1], idx[:, 2]].add(values)
        out = _fold(acc, spec, mesh_axis_names, mesh_shape, shear_dy)
        return out[0] if squeeze else out
    if mask is not None:
        i0 = jnp.clip(i0, 0, mx - 3)
        j0 = jnp.clip(j0, 0, my - 3)
        k0 = jnp.clip(k0, 0, mz - 3)
    # One scatter instead of 27: deposit every cloud cell's contribution
    # as a CHANNEL at the particle's anchor cell in ONE scatter, then
    # realign channels with K³ cheap grid rolls (anchor+offset stays
    # inside the ghost margin, so the circular roll never wraps mass).
    Ka, Kb, Kc = len(wx), len(wy), len(wz)
    K = Ka * Kb * Kc
    flat0 = (i0 * my + j0) * mz + k0
    ws = []
    for a in range(Ka):
        for b in range(Kb):
            for c in range(Kc):
                ws.append(wx[a] * wy[b] * wz[c])
    w = jnp.stack(ws)                                  # (K, npar)
    vals = values[:, None, :] * w[None]                # (nc, K, npar)
    accf = jnp.zeros((nc, K, mx * my * mz), dtype)
    accf = accf.at[:, :, flat0].add(vals)
    accf = accf.reshape(nc, K, mx, my, mz)
    k_ = 0
    for a in range(Ka):
        for b in range(Kb):
            for c in range(Kc):
                ch = accf[:, k_]
                if a:
                    ch = jnp.roll(ch, a, axis=1)
                if b:
                    ch = jnp.roll(ch, b, axis=2)
                if c:
                    ch = jnp.roll(ch, c, axis=3)
                acc = acc + ch
                k_ += 1
    out = _fold(acc, spec, mesh_axis_names, mesh_shape, shear_dy)
    return out[0] if squeeze else out


def _fold(acc, spec, mesh_axis_names, mesh_shape, shear_dy=None):
    if mesh_axis_names and any(
            n is not None and s > 1
            for n, s in zip(mesh_axis_names, mesh_shape)):
        from ..parallel.halo import fold_ghosts
        return fold_ghosts(acc, spec, mesh_axis_names, mesh_shape)
    return _fold_ghosts(acc, spec, shear_dy)


def _fold_ghosts(acc, spec, shear_dy=None):
    """Adjoint of the periodic ghost fill: ghost-zone contributions are
    added back to their interior images, then ghosts dropped.

    ``shear_dy``: shear-periodic x faces — the x-ghost slabs are Fourier
    y-shifted by ∓deltay before folding (adjoint of the shearing ghost
    fill; the y/z axes are folded FIRST so the slabs carry interior-only
    y when the shift runs)."""
    g = NGHOST
    order = (1, 2, 0) if shear_dy is not None else (0, 1, 2)
    for axis in order:
        ax = acc.ndim - 3 + axis
        m = acc.shape[ax]
        n = m - 2 * g
        if spec.periodic[axis] and n < g:
            # short/degenerate axis (e.g. nz=1): slab folds would read
            # other ghost cells — fold every plane modularly instead
            import numpy as np_
            idx = np_.mod(np_.arange(m) - g, n)
            body = jnp.zeros(acc.shape[:ax] + (n,) + acc.shape[ax + 1:],
                             acc.dtype)
            for j in range(m):
                body = jax.lax.dynamic_update_index_in_dim(
                    body,
                    jax.lax.index_in_dim(body, int(idx[j]), axis=ax,
                                         keepdims=False)
                    + jax.lax.index_in_dim(acc, j, axis=ax,
                                           keepdims=False),
                    int(idx[j]), axis=ax)
            acc = body
            continue
        if not spec.periodic[axis]:
            # non-periodic: clip deposits into the edge cells
            pass
        lo_ghost = jax.lax.slice_in_dim(acc, 0, g, axis=ax)
        hi_ghost = jax.lax.slice_in_dim(acc, m - g, m, axis=ax)
        body = jax.lax.slice_in_dim(acc, g, m - g, axis=ax)
        if spec.periodic[axis]:
            if axis == 0 and shear_dy is not None:
                # lo ghosts (x < x0) live on the HIGH side at y − deltay:
                # fold with the inverse of the ghost-fill shift.  y was
                # folded first, so the slab's y extent is interior-only —
                # shift over the whole axis.
                def _yshift(slab, dy):
                    ny = slab.shape[-2]
                    fk = jnp.fft.rfft(slab, axis=-2)
                    k = jnp.fft.rfftfreq(ny, d=spec.Ly / ny).reshape(-1, 1)
                    ph = jnp.exp(-2j * jnp.pi * k * dy)
                    return jnp.fft.irfft(fk * ph, n=ny,
                                         axis=-2).astype(slab.dtype)

                lo_ghost = _yshift(lo_ghost, -shear_dy)
                hi_ghost = _yshift(hi_ghost, shear_dy)
            # lo ghosts map onto the high end of the interior, hi onto low
            hi_img = jax.lax.slice_in_dim(body, n - g, n, axis=ax) + lo_ghost
            lo_img = jax.lax.slice_in_dim(body, 0, g, axis=ax) + hi_ghost
            body = jax.lax.dynamic_update_slice_in_dim(body, hi_img, n - g, axis=ax)
            body = jax.lax.dynamic_update_slice_in_dim(body, lo_img, 0, axis=ax)
        acc = body
    return acc
