"""Ghost-zone fill: local wrap or device-to-device neighbor exchange.

JAX analog of reference ``src/mpicomm.f90`` halo machinery
(``initiate_isendrcv_bdry`` :1325, ``finalize_isendrcv_bdry`` :1704) and
``src/boundcond.f90`` ``update_ghosts`` (:60-138).  The MPI ISend/IRecv of
y/z slabs + corner strips collapses to at most six ``jax.lax.ppermute``
slab exchanges over the device mesh; corners come out right because axes
are filled sequentially and each exchange ships the full extent of the
previously-filled axes (same trick as the reference's x→y→z ordering).

Only the first ``reg.ncom`` components (evolved + communicated auxiliaries)
are exchanged — the reference's ``mcom`` concept (src/mpicomm.f90:1346) —
and the fill happens ONCE per RHS evaluation for all fields.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.boundary import apply_axis_bcs
from ..ops.stencil import NGHOST


def _wrap_axis(fg: jnp.ndarray, axis: int, g: int = NGHOST) -> jnp.ndarray:
    """Periodic fill of one spatial axis from the local interior."""
    ax = fg.ndim - 3 + axis
    m = fg.shape[ax]
    n = m - 2 * g
    if n < g:
        # short/degenerate axis (e.g. ny=1): a slab copy would read other
        # ghost cells — tile the interior periodically instead
        import numpy as np
        idx = g + np.mod(np.arange(m) - g, n)
        return jnp.take(fg, jnp.asarray(idx), axis=ax)
    hi_int = jax.lax.slice_in_dim(fg, m - 2 * g, m - g, axis=ax)
    lo_int = jax.lax.slice_in_dim(fg, g, 2 * g, axis=ax)
    fg = jax.lax.dynamic_update_slice_in_dim(fg, hi_int, 0, axis=ax)
    fg = jax.lax.dynamic_update_slice_in_dim(fg, lo_int, m - g, axis=ax)
    return fg


def _exchange_axis(fg: jnp.ndarray, axis: int, axis_name: str, psize: int,
                   g: int = NGHOST) -> jnp.ndarray:
    """ppermute ring exchange of ghost slabs along one sharded mesh axis."""
    ax = fg.ndim - 3 + axis
    m = fg.shape[ax]
    hi_int = jax.lax.slice_in_dim(fg, m - 2 * g, m - g, axis=ax)
    lo_int = jax.lax.slice_in_dim(fg, g, 2 * g, axis=ax)
    fwd = [(i, (i + 1) % psize) for i in range(psize)]
    bwd = [(i, (i - 1) % psize) for i in range(psize)]
    # my high-interior becomes my right neighbour's low ghost
    lo_ghost = jax.lax.ppermute(hi_int, axis_name, fwd)
    hi_ghost = jax.lax.ppermute(lo_int, axis_name, bwd)
    fg = jax.lax.dynamic_update_slice_in_dim(fg, lo_ghost, 0, axis=ax)
    fg = jax.lax.dynamic_update_slice_in_dim(fg, hi_ghost, m - g, axis=ax)
    return fg


def fill_ghosts(
    fa: jnp.ndarray,
    spec,
    bc_axes: Tuple[tuple, tuple, tuple],
    reg,
    grid,
    cfg,
    eos=None,
    mesh_axis_names: Optional[Tuple[Optional[str], ...]] = None,
    mesh_shape: Tuple[int, int, int] = (1, 1, 1),
    shear_dy=None,
) -> jnp.ndarray:
    """Interior stack (nc, nx, ny, nz) → ghosted stack (nc, mx, my, mz).

    When called inside ``shard_map``, ``mesh_axis_names`` gives the mesh
    axis name per spatial axis (None = unsharded) and ``mesh_shape`` the
    static device counts; physical BCs are then masked to domain-edge
    shards via ``lax.axis_index``.
    """
    g = spec.nghost
    pad = [(0, 0)] * (fa.ndim - 3) + [(g, g)] * 3
    fg = jnp.pad(fa, pad)
    for axis in range(3):
        name = mesh_axis_names[axis] if mesh_axis_names else None
        psize = mesh_shape[axis]
        if name is not None and psize > 1:
            fg = _exchange_axis(fg, axis, name, psize, g)
            if not spec.periodic[axis]:
                idx = jax.lax.axis_index(name)
                edge = (idx == 0, idx == psize - 1)
                fg = apply_axis_bcs(fg, axis, bc_axes[axis], reg, grid, cfg,
                                    eos, edge_mask=edge)
        else:
            fg = _wrap_axis(fg, axis, g)
            if not spec.periodic[axis]:
                fg = apply_axis_bcs(fg, axis, bc_axes[axis], reg, grid, cfg,
                                    eos, edge_mask=(True, True))
        if axis == 0 and shear_dy is not None:
            # shear-periodic x faces: ghost slabs y-shifted by ±deltay
            # (reference initiate_shearing, src/mpicomm.f90:2104-2422 —
            # there the shift spans up to 3 y-neighbor ranks; here a
            # sharded y axis all-gathers the thin face slab's interior
            # rows, Fourier-shifts over the GLOBAL y circle, and slices
            # the local block back out.  A sharded x axis shifts only on
            # the domain-edge shards: interior x faces came from real
            # neighbors via ppermute and must stay unshifted.)
            from ..physics.shear import fourier_shift_y
            yname = mesh_axis_names[1] if mesh_axis_names else None
            ysh = mesh_shape[1] if yname is not None else 1
            ny_loc = spec.ny // ysh
            ax = fg.ndim - 3
            ay = fg.ndim - 2
            m = fg.shape[ax]

            def yshift(slab, dy):
                if ysh == 1:
                    return fourier_shift_y(slab, dy, spec.Ly,
                                           ny_int=spec.ny)
                y_int = jax.lax.slice_in_dim(slab, g, g + ny_loc, axis=ay)
                full = jax.lax.all_gather(y_int, yname, axis=ay,
                                          tiled=True)
                fk = jnp.fft.rfft(full, axis=ay)
                k = jnp.fft.rfftfreq(spec.ny, d=spec.Ly / spec.ny)
                kshape = [1] * slab.ndim
                kshape[ay] = -1
                phase = jnp.exp(-2j * jnp.pi * k.reshape(kshape) * dy)
                shifted = jnp.fft.irfft(fk * phase, n=spec.ny,
                                        axis=ay).astype(slab.dtype)
                iy = jax.lax.axis_index(yname)
                mine = jax.lax.dynamic_slice_in_dim(
                    shifted, iy * ny_loc, ny_loc, axis=ay)
                return jax.lax.dynamic_update_slice_in_dim(
                    slab, mine, g, axis=ay)

            lo = jax.lax.slice_in_dim(fg, 0, g, axis=ax)
            hi = jax.lax.slice_in_dim(fg, m - g, m, axis=ax)
            lo_s = yshift(lo, shear_dy)
            hi_s = yshift(hi, -shear_dy)
            if name is not None and psize > 1:
                idx = jax.lax.axis_index(name)
                lo_s = jnp.where(idx == 0, lo_s, lo)
                hi_s = jnp.where(idx == psize - 1, hi_s, hi)
            fg = jax.lax.dynamic_update_slice_in_dim(fg, lo_s, 0, axis=ax)
            fg = jax.lax.dynamic_update_slice_in_dim(fg, hi_s, m - g, axis=ax)
    return fg


def fold_ghosts(acc, spec, mesh_axis_names=None, mesh_shape=(1, 1, 1)):
    """Adjoint of the ghost fill for scatter-deposits: ghost-zone
    contributions are shipped to the neighbor that owns those cells
    (reverse ppermute) or wrapped locally, then added to the interior.

    acc: ghosted accumulator (..., mx, my, mz) → interior (..., nx, ny, nz).
    """
    g = spec.nghost
    for axis in range(3):
        ax = acc.ndim - 3 + axis
        m = acc.shape[ax]
        n = m - 2 * g
        lo_ghost = jax.lax.slice_in_dim(acc, 0, g, axis=ax)
        hi_ghost = jax.lax.slice_in_dim(acc, m - g, m, axis=ax)
        body = jax.lax.slice_in_dim(acc, g, m - g, axis=ax)
        name = mesh_axis_names[axis] if mesh_axis_names else None
        psize = mesh_shape[axis]
        if name is not None and psize > 1:
            # my low ghosts belong to my LEFT neighbour's high interior
            fwd = [(i, (i + 1) % psize) for i in range(psize)]
            bwd = [(i, (i - 1) % psize) for i in range(psize)]
            from_right = jax.lax.ppermute(lo_ghost, name, bwd)   # their lo → my hi
            from_left = jax.lax.ppermute(hi_ghost, name, fwd)    # their hi → my lo
            hi_img = jax.lax.slice_in_dim(body, n - g, n, axis=ax) + from_right
            lo_img = jax.lax.slice_in_dim(body, 0, g, axis=ax) + from_left
        else:
            hi_img = jax.lax.slice_in_dim(body, n - g, n, axis=ax) + lo_ghost
            lo_img = jax.lax.slice_in_dim(body, 0, g, axis=ax) + hi_ghost
        body = jax.lax.dynamic_update_slice_in_dim(body, hi_img, n - g, axis=ax)
        body = jax.lax.dynamic_update_slice_in_dim(body, lo_img, 0, axis=ax)
        acc = body
    return acc
