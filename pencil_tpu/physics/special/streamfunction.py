"""Stokes-flow streamfunction convection (reference
``src/special/streamfunction_fullmultigrid.f90``: mantle/ice-shell
convection at infinite Prandtl number — each step SOLVES the 4th-order
momentum equation for the streamfunction ψ

    ∇⁴ψ = (α_th ρ₀ g / η) ∂T/∂x            (constant viscosity)

with ψ = 0 and antisymmetric ghosts on all walls
(``update_bounds_psi`` :922-964), derives u_q = (∂_z ψ, 0, −∂_x ψ) and
advects/diffuses temperature with it (``special_calc_energy``
:966-1060; ``lsplit_temperature`` evolves the perturbation around the
conductive profile).

JAX-native: the reference iterates SOR/full-multigrid over the
6th/4th-order discrete operator to tolerance 1e-15 (solve_highorder
:630-782).  Under the antisymmetric wall ghosts the SAME discrete
stencils diagonalize in the DST-I (sine) basis, so we solve the exact
discrete system in closed form: Ψ̂ = R̂ / (s4x + s4z + 2·s2x·s2z) with
s2/s4 the sine symbols of the reference's −490/180 and 56/6 stencils —
one pair of small dense sine-matrix matmuls per step instead of
thousands of relaxation sweeps, identical to the multigrid answer at
roundoff."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax.numpy as jnp
import numpy as np

from ..base import ModuleBase, accumulate
from . import register_special
from ...ops import stencil as st


def _sine_basis(n_int, dtype):
    """DST-I matrix S[k,j] = sin(πkj/(n_int+1)), k,j = 1..n_int."""
    j = np.arange(1, n_int + 1)
    S = np.sin(np.pi * np.outer(j, j) / (n_int + 1))
    return jnp.asarray(S, dtype)


def _symbols(n_int, d1, dtype):
    """Sine symbols of the reference's discrete d²/dx² and d⁴/dx⁴
    stencils (solve_highorder coefficient tables)."""
    th = np.pi * np.arange(1, n_int + 1) / (n_int + 1)
    c1, c2, c3 = np.cos(th), np.cos(2 * th), np.cos(3 * th)
    s2 = (d1 ** 2 / 180.0) * (-490.0 + 540.0 * c1 - 54.0 * c2 + 4.0 * c3)
    s4 = (d1 ** 4 / 6.0) * (56.0 - 78.0 * c1 + 24.0 * c2 - 2.0 * c3)
    return jnp.asarray(s2, dtype), jnp.asarray(s4, dtype)


@register_special("streamfunction_fullmultigrid")
@dataclass(frozen=True)
class Streamfunction(ModuleBase):
    name: ClassVar[str] = "streamfunction"

    amplpsi: float = 1e-7
    Tbot: float = 270.0
    Tupp: float = 100.0
    gravity_z: float = 1.3
    rho0_bq: float = 917.0
    alpha_thermal: float = 1.65e-4
    kappa: float = 1e-6
    eta_0: float = 1e13
    ampltt: float = 0.0
    kx_TT: float = np.pi
    kz_TT: float = np.pi
    initTT: str = "single-mode"
    lsplit_temperature: bool = True
    ltemperature_advection: bool = True
    ltemperature_diffusion: bool = True

    def register(self, reg):
        # TT first, then psi — matches the reference's registration order
        # (ENTROPY=temperature_idealgas registers iTT before the special
        # claims ipsi), so bcx/bcz component lists line up
        reg.register("TT", 1, "pde")
        reg.register("psi", 1, "pde")

    # -- ψ solve ---------------------------------------------------------
    def solve_psi(self, dTdx, spec, dtype):
        """Interior ψ from the exact sine-space solve of the reference's
        discrete operator; returns (nx, 1, nz) with wall points zero."""
        nx, nz = spec.nx, spec.nz
        Mx, Mz = nx - 2, nz - 2
        d1x = 1.0 / spec.dx
        d1z = 1.0 / spec.dz
        ra = self.alpha_thermal * self.rho0_bq * self.gravity_z
        rhs = (ra / self.eta_0) * dTdx[:, 0, :]            # (nx, nz)
        r_in = rhs[1:-1, 1:-1]                             # unknowns only
        Sx = _sine_basis(Mx, dtype)
        Sz = _sine_basis(Mz, dtype)
        s2x, s4x = _symbols(Mx, d1x, dtype)
        s2z, s4z = _symbols(Mz, d1z, dtype)
        L = (s4x[:, None] + s4z[None, :]
             + 2.0 * s2x[:, None] * s2z[None, :])
        rhat = (2.0 / (Mx + 1)) * (Sx @ ((2.0 / (Mz + 1)) * (r_in @ Sz)))
        phat = rhat / L
        psi_in = Sx @ (phat @ Sz)
        psi = jnp.zeros((nx, nz), dtype)
        psi = psi.at[1:-1, 1:-1].set(psi_in)
        return psi[:, None, :]

    def _psi_ghosted(self, psi):
        """Wall-antisymmetric ghost extension in x and z
        (update_bounds_psi: ghosts = 2·ψ_wall − mirror with ψ_wall=0)."""
        g = 3
        pad = jnp.pad(psi, ((g, g), (g, g), (g, g)))
        for ax, n in ((0, psi.shape[0]), (2, psi.shape[2])):
            for j in range(1, g + 1):
                lo_m = jnp.take(pad, g + j, axis=ax)
                hi_m = jnp.take(pad, g + n - 1 - j, axis=ax)
                pad = _put(pad, ax, g - j, -lo_m)
                pad = _put(pad, ax, g + n - 1 + j, -hi_m)
        # degenerate y: tile the single interior plane
        pad = pad.at[:, :g].set(pad[:, g:g + 1])
        pad = pad.at[:, -g:].set(pad[:, g:g + 1])
        return pad

    # -- RHS -------------------------------------------------------------
    def rhs(self, pen, df, ts):
        spec = pen.cfg.grid
        dtype = pen.fg.dtype
        dTdx = pen.d("TT", 0)[0]
        psi = self.solve_psi(dTdx, spec, dtype)
        pen._cache["psi_solved"] = psi
        pg = self._psi_ghosted(psi)
        d1x = 1.0 / spec.dx
        d1z = 1.0 / spec.dz
        uqx = st.i(st._der_n(pg[None], 2, None, 1, 6),
                   (0, 1)) [0] * d1z
        uqz = -st.i(st._der_n(pg[None], 0, None, 1, 6),
                    (1, 2))[0] * d1x
        pen._cache["uq"] = (uqx, uqz)
        out = 0.0
        if self.ltemperature_advection:
            gT = pen.grad("TT")
            out = out - (uqx * gT[0] + uqz * gT[2])
            if self.lsplit_temperature:
                gcond = (self.Tupp - self.Tbot) / spec.Lz
                out = out - uqz * gcond
        if self.ltemperature_diffusion:
            out = out + self.kappa * pen.del2s("TT")
            ts.diffus(self.kappa)
        accumulate(df, "TT", out)
        d1 = pen.dline_1()
        ts.advec(jnp.abs(uqx) * d1[0] + jnp.abs(uqz) * d1[2])

    def after_timestep(self, state, grid, cfg, reg, eos, dt, t, key,
                       it=None):
        """Store the freshly solved ψ back into its slot (the slot itself
        is slaved — kept for restart/diagnostic parity)."""
        spec = cfg.grid
        fg = jnp.pad(state["TT"][None],
                     [(0, 0)] + [(3, 3)] * 3, mode="edge")
        # cheap interior gradient for the stored psi (diagnostic only)
        dT = st.i(st._der_n(fg, 0, None, 1, 6), (1, 2))[0] / spec.dx
        state = dict(state)
        state["psi"] = self.solve_psi(dT, spec, state["TT"].dtype)
        return state

    def init_fields(self, grid, spec, eos, key, cfg=None):
        zero = jnp.zeros(spec.shape, grid.z.dtype)
        if self.initTT == "single-mode" and self.ampltt != 0.0:
            x = grid.x[3:-3]
            z = grid.z[3:-3]
            TT = self.ampltt * (jnp.cos(self.kx_TT * (x - spec.x0)
                                        / spec.Lx)[:, None, None]
                                * jnp.sin(self.kz_TT * (z - spec.z0)
                                          / spec.Lz)[None, None, :]) + zero
        else:
            TT = zero
        return {"TT": TT, "psi": zero}


def _put(arr, axis, idx, plane):
    return jnp.moveaxis(
        jnp.moveaxis(arr, axis, 0).at[idx].set(plane), 0, axis)
