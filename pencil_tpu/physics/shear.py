"""Shearing box (reference ``src/shear.f90`` + the shear-periodic halo path
``initiate_shearing``/``finalize_shearing`` in src/mpicomm.f90:2104-2422).

Co-moving formulation with background flow U₀ = S·x ŷ, S = −qΩ (Keplerian
q = 3/2).  Terms added to every evolved field f: −S x ∂f/∂y (advection by
the background shear), plus:
    hydro:     duy/dt −= S·ux            (tidal/shear stress)
    magnetic:  dAx/dt −= S·Ay            (reference daa_dt "+3/2 Ω A_y x̂")
The x boundary is *shear-periodic*: f(x+Lx, y) = f(x, y − S·Lx·t); the
ghost-slab y-shift is realized as an exact Fourier shift (periodic y), the
JAX-native replacement for the reference's 6th-order polynomial
interpolation across y-neighbor ranks."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax.numpy as jnp

from .base import ModuleBase, accumulate


@dataclass(frozen=True)
class Shear(ModuleBase):
    name: ClassVar[str] = "shear"

    qshear: float = 1.5
    Omega: float = 1.0
    # direct shear rate (reference Sshear namelist: when set it overrides
    # −qshear·Omega, shear.f90:96 — used by pure-shear runs with Ω=0)
    Sshear: float = 0.0
    # SAFI (reference lshearadvection_as_shift, shear.f90:40): the
    # background-shear advection −u₀∂_y is removed from the RHS (and from
    # the CFL) and applied per substep as an exact x-dependent Fourier
    # y-shift following Gammie 2001 (advance_shear → sheared_advection_fft
    # shear.f90:536-579).
    lshearadvection_as_shift: bool = False

    @property
    def S(self) -> float:
        if self.Sshear != 0.0:
            return self.Sshear
        return -self.qshear * self.Omega

    def deltay(self, t, Lx, Ly):
        return jnp.mod(-self.S * Lx * t, Ly)

    def rhs(self, pen, df, ts):
        S = self.S
        x = pen.grid.xg  # (nx,1,1) local coordinates
        uy0 = S * x
        if not self.lshearadvection_as_shift:
            # advect every evolved field by the background flow: −uy0 ∂f/∂y
            for name, slot in pen.reg.slots.items():
                if slot.kind != "pde":
                    continue
                dfy = pen.d(name, 1)
                term = -uy0 * dfy
                accumulate(df, name, term[0] if slot.ncomp == 1 else term)
            # background-flow advective CFL (removed under SAFI — the
            # shift is exact, shear.f90 "Removes time-step constraint")
            d1 = pen.dline_1()
            ts.advec(jnp.abs(uy0) * d1[1])
        # shear acceleration handed over to Particles_drag when active
        # (reference shear.f90:160)
        pdrag = pen.cfg.module("particles_drag") if pen.cfg else None
        if "uu" in pen.reg.slots and pdrag is None:
            uu = pen.uu()
            zero = jnp.zeros_like(uu[0])
            accumulate(df, "uu", jnp.stack([zero, -S * uu[0], zero]))
        if "aa" in pen.reg.slots:
            aa = pen.aa()
            zero = jnp.zeros_like(aa[0])
            accumulate(df, "aa", jnp.stack([-S * aa[1], zero, zero]))
        if "aatest" in pen.reg.slots:
            # test-field stretching: dax^q/dt −= S·ay^q per quartet
            # (shear.f90:358-361)
            at = pen.field("aatest")
            dat = jnp.zeros_like(at)
            for q in range(at.shape[0] // 3):
                dat = dat.at[3 * q].set(-S * at[3 * q + 1])
            accumulate(df, "aatest", dat)

    def shift_advection(self, arr, grid, spec, dtsub):
        """Exact shear-advection shift of (ncomp, nx, ny, nz) interior
        fields: f(x, y) ← f(x, y − S·x·dtsub) via per-x-plane Fourier
        phase (reference sheared_advection_fft)."""
        uy0 = self.S * grid.xg[:, 0, 0]              # (nx,)
        shift = uy0 * dtsub
        fk = jnp.fft.rfft(arr, axis=2)
        k = jnp.fft.rfftfreq(spec.ny, d=spec.Ly / spec.ny)
        phase = jnp.exp(-2j * jnp.pi * k[None, :] * shift[:, None])
        out = jnp.fft.irfft(fk * phase[None, :, :, None], n=spec.ny,
                            axis=2)
        return out.astype(arr.dtype)


def fourier_shift_y(slab, dy, Ly, ny_int=None):
    """Shift a ghosted-y slab by dy along the (periodic) interior y axis.

    slab: (..., my, mz) with my = ny + 2·nghost (+ optional high-side
    alignment padding — pass ``ny_int`` so the FFT runs over exactly the
    periodic interior and the pad rows are left untouched)."""
    from ..ops.stencil import NGHOST
    g = NGHOST
    if ny_int is None:
        ny_int = slab.shape[-2] - 2 * g
    y_int = slab[..., g:g + ny_int, :]
    ny = ny_int
    fk = jnp.fft.rfft(y_int, axis=-2)
    k = jnp.fft.rfftfreq(ny, d=Ly / ny).reshape((-1, 1))
    phase = jnp.exp(-2j * jnp.pi * k * dy)
    shifted = jnp.fft.irfft(fk * phase, n=ny, axis=-2).astype(slab.dtype)
    return slab.at[..., g:g + ny, :].set(shifted)
