"""High-order central finite-difference stencil operators.

JAX analog of reference ``src/deriv.f90`` (``der_main`` at :89,
``der2_main`` at :474, der3..der6, ``der6_upwind``, ``derij``).  Instead of
hard-coding the classical coefficient tables, we *derive* them at trace time
from the Taylor/Vandermonde system (Fornberg weights) for any stencil width —
this covers the reference's swappable 2nd/6th/8th/10th-order derivative
modules (``src/deriv_2nd.f90``, ``deriv_8th.f90``, ``deriv_10th.f90``):
set ``GridSpec.nghost`` (3 → 6th order, 4 → 8th, 5 → 10th) and the full
(2·nghost+1)-point stencil is used everywhere (halo, pencils, BCs gate on
nghost=3 for now).

All operators take a *ghosted* array whose trailing three axes are (x, y, z)
with ``nghost`` ghost cells per side, reduce the target axis from m → n, and
leave other axes untouched; the ``i()`` helper crops remaining ghosts.
Scaling factors (``inv_d``) are broadcastable arrays (1/Δ per point) taken
from the Grid metric vectors, which is what makes non-equidistant grids work
(reference ``src/deriv.f90:141-160``).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

NGHOST = 3


@functools.lru_cache(maxsize=None)
def fd_weights(offsets: tuple, deriv: int) -> tuple:
    """Finite-difference weights for d^k/dx^k on unit-spaced ``offsets``.

    Solves sum_j w_j * o_j^m = m! * delta_{m,k} for m = 0..len-1 (standard
    method of undetermined coefficients; equivalent to Fornberg 1988).
    """
    n = len(offsets)
    if deriv >= n:
        raise ValueError("stencil too small for derivative order")
    A = np.vander(np.asarray(offsets, dtype=np.float64), n, increasing=True).T
    b = np.zeros(n)
    b[deriv] = math.factorial(deriv)
    w = np.linalg.solve(A, b)
    w[np.abs(w) < 1e-13] = 0.0
    return tuple(w)


def central_offsets(halfwidth: int) -> tuple:
    return tuple(range(-halfwidth, halfwidth + 1))


def _axis_index(fg: jnp.ndarray, axis: int) -> int:
    """Map spatial axis 0/1/2 → actual array axis (trailing three dims)."""
    return fg.ndim - 3 + axis


def i(arr: jnp.ndarray, axes=(0, 1, 2), g: int = NGHOST) -> jnp.ndarray:
    """Crop ghost zones along the given spatial axes (interior view).

    The caller must pass exactly the axes that are still ghosted — axis
    extents are not inspected (an interior extent can exceed 2·nghost).
    """
    idx = [slice(None)] * arr.ndim
    for a in axes:
        ax = arr.ndim - 3 + a
        idx[ax] = slice(g, -g)
    return arr[tuple(idx)]


def _stencil_axis_paired(fg, axis, weights, offsets, parity, g=NGHOST):
    """Central stencil evaluated in PAIRED form so constants cancel
    EXACTLY in floating point (the reference's
    45*(f(+1)−f(−1)) − 9*(f(+2)−f(−2)) + ... arrangement,
    src/deriv.f90:89-171):

      odd  derivative:  Σ_{o>0} w_o·(f₊ₒ − f₋ₒ)
      even derivative:  Σ_{o>0} w_o·(f₊ₒ + f₋ₒ − 2·f₀)

    The naive per-tap sum leaves an O(eps)·|f| residue on constant fields
    which, scaled by dx⁻ⁿ, becomes a spurious uniform force on small
    boxes (dx_1 ~ 10³ broke the streaming-instability equilibrium)."""
    ax = _axis_index(fg, axis)
    n = fg.shape[ax] - 2 * g
    pos = [(o, w) for o, w in zip(offsets, weights) if o > 0 and w != 0.0]

    def shift(o):
        return jax.lax.slice_in_dim(fg, g + o, g + o + n, axis=ax)

    out = None
    for o, w in pos:
        if parity == 1:
            term = w * (shift(o) - shift(-o))
        else:
            term = w * (shift(o) + shift(-o) - 2.0 * shift(0))
        out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(shift(0))
    return out


def _der_n(fg, axis, inv_d, deriv, accuracy, g=NGHOST):
    """Width-generic central derivative: the full (2g+1)-point stencil of
    the ghost zone is used, so accuracy follows the configured ghost width
    (g=3 → 6th order like src/deriv.f90; g=4 → 8th order deriv_8th.f90;
    g=5 → 10th order deriv_10th.f90)."""
    hw = (deriv + 1) // 2
    if hw > g:
        raise ValueError(f"stencil halfwidth {hw} exceeds nghost={g}")
    offs = central_offsets(g)
    w = fd_weights(offs, deriv)
    out = _stencil_axis_paired(fg, axis, w, offs, deriv % 2, g=g)
    if inv_d is not None:
        out = out * _pow_scale(inv_d, deriv)
    return out


def _pow_scale(inv_d, p):
    if p == 1:
        return inv_d
    return inv_d ** p


def der(fg, axis, inv_d=None, g=NGHOST):
    """1st derivative, 6th-order central (reference der_main, deriv.f90:89)."""
    return _der_n(fg, axis, inv_d, 1, 6, g=g)


def der2(fg, axis, inv_d=None, tilde=None, g=NGHOST):
    """2nd derivative, 6th-order central (reference der2_main, deriv.f90:474).

    ``tilde`` is the nonuniform-grid metric −x''/x'² ; when given, adds the
    first-derivative correction term for stretched grids.
    """
    out = _der_n(fg, axis, inv_d, 2, 6, g=g)
    if tilde is not None:
        out = out + tilde * der(fg, axis, inv_d, g=g)
    return out


def der3(fg, axis, inv_d=None):
    return _der_n(fg, axis, inv_d, 3, 4)


def der4(fg, axis, inv_d=None):
    return _der_n(fg, axis, inv_d, 4, 4)


def der5(fg, axis, inv_d=None):
    return _der_n(fg, axis, inv_d, 5, 2)


def der6(fg, axis, inv_d=None, g=NGHOST):
    """6th derivative on the 7-pt stencil (used by del6 hyperdiffusion)."""
    return _der_n(fg, axis, inv_d, 6, 2, g=g)


_UPWIND_W = None


def der6_upw(fg, axis, inv_d):
    """Upwind dissipation operator: |δ⁶|-style 5th-order upwinding term.

    Matches the reference's ``der6(...,UPWIND=.true.)`` convention
    (``src/deriv.f90`` der6 with upwind scaling): the 6th-difference pattern
    scaled by 1/(60·Δ) — i.e. Δ⁵/60 · ∂⁶f — added as |u|·der6_upw(f) to
    advection terms to damp grid-scale wiggles (lupw_* flags).
    """
    offs = central_offsets(NGHOST)
    w6 = fd_weights(offs, 6)            # [1,-6,15,-20,15,-6,1]
    w = tuple(x / 60.0 for x in w6)
    out = _stencil_axis_paired(fg, axis, w, offs, 0)
    return out * inv_d


def derij(fg, ax1, ax2, inv1=None, inv2=None):
    """Mixed second derivative ∂²/∂x_i∂x_j by composition of two 1-D
    first-derivative passes (reference derij_main with
    lbidiagonal_derij=F)."""
    if ax1 == ax2:
        raise ValueError("use der2 for repeated axes")
    d1 = _der_n(fg, ax1, None, 1, 6)   # reduces ax1, keeps ax2 ghosted
    out = _der_n(d1, ax2, None, 1, 6)
    if inv1 is not None:
        out = out * inv1
    if inv2 is not None:
        out = out * inv2
    return out


def derij_bidiag(fg, ax1, ax2, inv1=None, inv2=None):
    """Mixed second derivative, 12-point bidiagonal scheme — the
    reference DEFAULT (``derij_main``, deriv.f90:1376-1420,
    ``lbidiagonal_derij=.true.`` cdata.f90:568): 6th-order using only the
    three neighbours on each half-diagonal, one pass instead of two."""
    if ax1 == ax2:
        raise ValueError("use der2 for repeated axes")
    a1 = _axis_index(fg, ax1)
    a2 = _axis_index(fg, ax2)
    n1 = fg.shape[a1] - 2 * NGHOST
    n2 = fg.shape[a2] - 2 * NGHOST
    out = None
    for o, c in zip((1, 2, 3), (270.0 / 720.0, -27.0 / 720.0, 2.0 / 720.0)):
        for s1, s2, sgn in ((o, o, 1.0), (-o, o, -1.0),
                            (-o, -o, 1.0), (o, -o, -1.0)):
            sl = jax.lax.slice_in_dim(fg, NGHOST + s1, NGHOST + s1 + n1,
                                      axis=a1)
            sl = jax.lax.slice_in_dim(sl, NGHOST + s2, NGHOST + s2 + n2,
                                      axis=a2)
            t = (sgn * c) * sl
            out = t if out is None else out + t
    if inv1 is not None:
        out = out * inv1
    if inv2 is not None:
        out = out * inv2
    return out
