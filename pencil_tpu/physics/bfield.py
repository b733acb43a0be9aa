"""Direct magnetic-field evolution (reference ``src/bfield.f90`` — the
MAGNETIC=bfield slot variant): evolves B itself instead of the vector
potential,

    dB/dt = −∇×E,   E = −u×(B + B_ext) [+ η µ₀ J when explicit]

(magnetic_after_boundary builds E on the full ghosted block from the
ghosted u and B, :428-534, so ∇×E needs no extra halo exchange; daa_dt
applies −curle and the Lorentz force J×B/ρ, :625-685).  J = µ₀⁻¹∇×B.
With ``limplicit_resistivity`` the η term is integrated exactly in
spectral space after each full step (split_update_magnetic →
implicit_diffusion.f90 'fft': B̂ ← B̂ e^{−η k² dt}).  The Alfvén CFL is
advec_va2 = Σ(B_a·dline_a)²µ₀⁻¹/ρ (:1203)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

import jax.numpy as jnp

from ..ops import stencil as st
from ..ops.stencil import i as interior
from .base import ModuleBase, accumulate

_OTHER_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _der_int(pen, arr_g, axis):
    """Interior derivative of an explicitly ghosted array, mirroring
    Pencils.d for non-slot quantities."""
    out = st.der(arr_g, axis, None, g=pen._g)
    return interior(out, _OTHER_AXES[axis],
                    g=pen._g) * pen._inv(axis)


def _curl_int(pen, vg):
    """Interior curl of a ghosted (3, mx, my, mz) vector (cartesian)."""
    return jnp.stack([
        _der_int(pen, vg[2], 1) - _der_int(pen, vg[1], 2),
        _der_int(pen, vg[0], 2) - _der_int(pen, vg[2], 0),
        _der_int(pen, vg[1], 0) - _der_int(pen, vg[0], 1),
    ])


@dataclass(frozen=True)
class Bfield(ModuleBase):
    name: ClassVar[str] = "bfield"

    eta: float = 0.0
    B_ext: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    limplicit_resistivity: bool = False
    llorentzforce: bool = True
    mu0: float = 1.0

    def register(self, reg):
        reg.register("bb", 3, "pde", comps=("bx", "by", "bz"))

    def _b_tot_g(self, pen):
        bg = pen._gh("bb")
        if any(b != 0.0 for b in self.B_ext):
            bg = bg + jnp.asarray(self.B_ext, bg.dtype)[:, None, None, None]
        return bg

    def rhs(self, pen, df, ts):
        bg = self._b_tot_g(pen)
        if "uu" in pen.reg.slots:
            ug = pen._gh("uu")
            # E = −u×B on the ghosted block (bfield.f90:525-531)
            eg = -jnp.stack([
                ug[1] * bg[2] - ug[2] * bg[1],
                ug[2] * bg[0] - ug[0] * bg[2],
                ug[0] * bg[1] - ug[1] * bg[0],
            ])
        else:
            eg = jnp.zeros_like(bg)
        accumulate(df, "bb", -_curl_int(pen, eg))
        if self.eta > 0.0 and not self.limplicit_resistivity:
            # explicit resistivity: the reference adds E += η µ0 J with a
            # communicated ghosted J; −∇×(ηµ0J) = η∇²B for constant η and
            # ∇·B = 0, which needs no second halo exchange
            lap = jnp.stack([
                sum(interior(st.der2(pen._gh("bb")[c], a, None, g=pen._g),
                             _OTHER_AXES[a], g=pen._g)
                    * pen._inv(a) ** 2 for a in range(3))
                for c in range(3)])
            accumulate(df, "bb", self.eta * lap)
            ts.diffus(self.eta)
        if self.llorentzforce and "uu" in pen.reg.slots:
            jj = _curl_int(pen, pen._gh("bb")) / self.mu0
            b_int = interior(bg, (0, 1, 2), g=pen._g)
            jxb = jnp.stack([
                jj[1] * b_int[2] - jj[2] * b_int[1],
                jj[2] * b_int[0] - jj[0] * b_int[2],
                jj[0] * b_int[1] - jj[1] * b_int[0],
            ])
            rho1 = pen.rho1()
            accumulate(df, "uu", jxb * rho1[None])
        # Alfvén-speed CFL (bfield.f90:1203)
        d1 = pen.dline_1()
        b_int = interior(bg, (0, 1, 2), g=pen._g)
        va2 = sum((b_int[a] * d1[a]) ** 2 for a in range(3)) \
            / self.mu0 * pen.rho1()
        ts.advec2(va2)

    def after_timestep(self, state, grid, cfg, reg, eos, dt, t, key,
                      it=None):
        if self.limplicit_resistivity and self.eta > 0.0:
            from ..ops.poisson import diffuse_fft
            state = dict(state)
            state["bb"] = diffuse_fft(state["bb"], cfg.grid, self.eta, dt)
        return state

    def init_fields(self, grid, spec, eos, key, cfg=None):
        import jax.numpy as jnp
        return {"bb": jnp.zeros((3, spec.nx, spec.ny, spec.nz),
                                grid.x.dtype)}
