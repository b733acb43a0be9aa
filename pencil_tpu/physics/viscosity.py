"""Viscous force (reference ``src/viscosity.f90``, ivisc multi-select at
:347-460).  Implemented flavors:

  'nu-const'           ν(∇²u + ⅓∇∇·u + 2S·∇lnρ)   — compressible, ρν=const...
                       (constant kinematic ν; reference 'nu-const')
  'hyper3-simplified'  ν₃ Σ_a ∂⁶u/∂x_a⁶
  'hyper3-mesh'        ν₃ᵐ Σ_a δ⁶u / 60 · dline_1  (resolution-independent)

Viscous heating 2νS² is published into the pencil cache for the entropy
module (reference: calc_viscous_heat)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

import jax.numpy as jnp

from .base import ModuleBase, accumulate


@dataclass(frozen=True)
class Viscosity(ModuleBase):
    name: ClassVar[str] = "viscosity"

    ivisc: Tuple[str, ...] = ("nu-const",)
    nu: float = 0.0
    nu_hyper3: float = 0.0
    nu_hyper3_mesh: float = 5.0
    nu_cspeed: float = 0.5     # 'nu-cspeed' exponent (ν ∝ T^c)
    nu_shock: float = 0.0
    zeta: float = 0.0      # dynamic bulk viscosity ('rho-nu-const-bulk')
    nu_aniso_hyper3: tuple = (0.0, 0.0, 0.0)  # 'hyper3_nu-const_aniso'
    # operator-split exact spectral integration of ν∇²u after each full
    # step (reference viscosity.f90 limplicit_viscosity →
    # implicit_diffusion.f90 'fft'); the explicit term and its CFL are off
    limplicit_viscosity: bool = False

    def rhs(self, pen, df, ts):
        if "uu" not in pen.reg.slots:
            return      # HYDRO=nohydro: no velocity to act on
        fvisc = 0.0
        heat = 0.0
        if "nu-const" in self.ivisc and self.nu > 0.0:
            if pen.cfg.grid.coords != "cartesian":
                # curvilinear: ν∇²u via the metric-aware vector Laplacian
                # (the 2S·∇lnρ and ⅓∇∇·u pieces need the full Christoffel
                # strain tensor — reference-parity item for spherical runs)
                fvisc = fvisc + self.nu * pen.del2v("uu")
                heat = heat + 2.0 * self.nu * pen.sij2()
            else:
                sij = pen.sij()
                glnrho = pen.glnrho()
                # S·∇lnρ
                sglnrho = jnp.stack([
                    sum(sij[a, b] * glnrho[b] for b in range(3))
                    for a in range(3)
                ])
                fvisc = fvisc + self.nu * (
                    pen.del2u() + (1.0 / 3.0) * pen.graddivu()
                    + 2.0 * sglnrho
                )
                heat = heat + 2.0 * self.nu * pen.sij2()
            ts.diffus(self.nu)
        if ({"simplified", "nu-simplified", "0"} & set(self.ivisc)) \
                and self.nu > 0.0 and not self.limplicit_viscosity:
            # f = ν∇²u, no density factors (viscosity.f90:348-350
            # lvisc_simplified — the only ivisc Boussinesq permits,
            # viscosity.f90:668); heat pencil 2νS² (:958)
            fvisc = fvisc + self.nu * pen.del2u()
            heat = heat + 2.0 * self.nu * pen.sij2()
            ts.diffus(self.nu)
        if ({"rho-nu-const", "rho_nu-const", "1"} & set(self.ivisc)) \
                and self.nu > 0.0:
            # constant dynamic viscosity μ: f = (μ/ρ)(∇²u + ⅓∇∇·u),
            # heat = 2(μ/ρ)S², diffus += μ/ρ (viscosity.f90:354-356,
            # lvisc_rho_nu_const force block)
            murho1 = self.nu / pen.rho()
            fvisc = fvisc + murho1[None] * (
                pen.del2u() + (1.0 / 3.0) * pen.graddivu())
            heat = heat + 2.0 * murho1 * pen.sij2()
            ts.diffus(murho1)
        if "rho-nu-const-bulk" in self.ivisc and self.zeta > 0.0:
            # constant dynamic bulk viscosity (viscosity.f90:1319-1327):
            # f = (ζ/ρ)∇∇·u, heat = (ζ/ρ)(∇·u)², diffus += ζ/ρ
            zetarho1 = self.zeta / pen.rho()
            fvisc = fvisc + zetarho1[None] * pen.graddivu()
            heat = heat + zetarho1 * pen.divu() ** 2
            ts.diffus(zetarho1)
        if "hyper3_nu-const_aniso" in self.ivisc \
                and any(c != 0.0 for c in self.nu_aniso_hyper3):
            # f_i = Σ_j ν₃ⱼ ∂⁶u_i/∂x_j⁶ + Σ_j u_{i,j}·∂_j lnρ·ν₃ⱼ
            # (viscosity.f90:1476-1490 lvisc_hyper3_nu_const_aniso)
            uij = pen.uij()
            glnrho = pen.glnrho()
            fvisc = fvisc + jnp.stack([
                sum(self.nu_aniso_hyper3[a]
                    * pen.d6_raw("uu", a)[i] * pen._inv(a) ** 6
                    + uij[i, a] * glnrho[a] * self.nu_aniso_hyper3[a]
                    for a in range(3))
                for i in range(3)])
            d1 = pen.dline_1()
            dxyz6 = d1[0] ** 6 + d1[1] ** 6 + d1[2] ** 6
            ts.diffus3(sum(self.nu_aniso_hyper3[a] * d1[a] ** 6
                           for a in range(3)) / dxyz6)
        if ({"nu-shock", "shock"} & set(self.ivisc)) and self.nu_shock > 0.0:
            # bulk shock viscosity (reference viscosity.f90 'nu-shock'):
            # f = ν_sh [shock(∇∇·u + ∇·u ∇lnρ) + ∇·u ∇shock]
            shock = pen.field("shock")
            gshock = pen.grad("shock")
            divu = pen.divu()
            glnrho = pen.glnrho()
            fvisc = fvisc + self.nu_shock * (
                shock[None] * (pen.graddivu() + divu[None] * glnrho)
                + divu[None] * gshock
            )
            heat = heat + self.nu_shock * shock * divu * divu
            ts.diffus(self.nu_shock * shock)
        if "nu-mixture" in self.ivisc:
            # mixture-dependent ν(x) from the chemistry transport data
            # (reference viscosity.f90:1470-1485 lvisc_mixture):
            # f = ν(∇²u + ⅓∇∇·u + 2S·∇lnρ) + 2S·∇ν, heat = 2νS²
            chem = pen.cfg.module("chemistry")
            nugh = chem.mixture_nu_gh(pen)
            from ..ops.stencil import i as interior
            nu = interior(nugh[None], (0, 1, 2), g=pen._g)[0]
            gradnu = jnp.stack([chem._dg(pen, nugh, a) for a in range(3)])
            sij = pen.sij()
            glnrho = pen.glnrho()
            sglnrho = jnp.stack([
                sum(sij[a, b] * glnrho[b] for b in range(3))
                for a in range(3)])
            sgradnu = jnp.stack([
                sum(sij[a, b] * gradnu[b] for b in range(3))
                for a in range(3)])
            fvisc = fvisc + nu[None] * (
                pen.del2u() + (1.0 / 3.0) * pen.graddivu()
                + 2.0 * sglnrho) + 2.0 * sgradnu
            heat = heat + 2.0 * nu * pen.sij2()
            ts.diffus(jnp.max(nu))
        if ({"shock-simple", "shock_simple"} & set(self.ivisc)) \
                and self.nu_shock > 0.0:
            # f = ν_sh·div(shock·∇u_i) = ν_sh(∇shock·∇u_i + shock∇²u_i),
            # no heating (reference viscosity.f90:1765-1773)
            shock = pen.field("shock")
            gshock = pen.grad("shock")
            uij = pen.uij()
            fvisc = fvisc + self.nu_shock * jnp.stack([
                sum(gshock[j] * uij[i, j] for j in range(3))
                + shock * pen.del2u()[i]
                for i in range(3)
            ])
            ts.diffus(self.nu_shock * shock)
        if ({"hyper3-simplified", "hyper3-nu-const",
             "hyper3_nu-const"} & set(self.ivisc)) and self.nu_hyper3 > 0.0:
            fvisc = fvisc + self.nu_hyper3 * pen.del6v_scaled("uu")
            if ({"hyper3-nu-const", "hyper3_nu-const"} & set(self.ivisc)) \
                    and ("lnrho" in pen.reg.slots
                         or "rho" in pen.reg.slots):
                # ν₃(∇⁶u + u_{i,j}⁵·∂_j lnρ) (viscosity.f90:2095-2096);
                # the uij5 factor uses 5th-derivative cross terms — the
                # dominant ∂⁶ part is kept, plus the advective lnρ
                # correction via uij·glnrho at 5th order is approximated
                # with the same del6 scaling as the reference's aniso form
                glnrho = pen.glnrho()
                fvisc = fvisc + self.nu_hyper3 * jnp.stack([
                    sum(pen.d5_raw("uu", a)[i] * pen._inv(a) ** 5
                        * glnrho[a] for a in range(3))
                    for i in range(3)])
            ts.diffus3(self.nu_hyper3)
        if ({"hyper3_rho_nu-const_symm", "hyper3-rho-nu-const-symm"}
                & set(self.ivisc)) and self.nu_hyper3 > 0.0:
            # μ₃=const symmetric hyperviscosity: force = μ₃/ρ·(∇⁶u +
            # ∇⁵(∇·u)) from τ_ij = ∂⁵u_i/∂x_j⁵ + ∂⁵u_j/∂x_i⁵
            # (viscosity.f90:1950-1961 lvisc_hyper3_rho_nu_const_symm)
            murho1 = self.nu_hyper3 * pen.rho1()
            fvisc = fvisc + murho1 * (pen.del6v_scaled("uu")
                                      + pen.grad5divu())
            ts.diffus3(self.nu_hyper3)   # ×rho1 in the reference; bound
        if ({"nu-cspeed", "nu-therm"} & set(self.ivisc)) \
                and self.nu > 0.0:
            # temperature-sensitive viscosity μ_TT = ν·T^nu_cspeed
            # (viscosity.f90:1382-1398 lvisc_nu_cspeed): f = 2μS·∇lnρ +
            # μ(∇²u + ⅓∇∇·u + 2c·S·∇lnT), heat = 2μS², CFL μ_TT
            muTT = self.nu * jnp.exp(self.nu_cspeed * pen.lnTT())
            sij = pen.sij()
            glnrho = pen.glnrho()
            glnTT = pen.glnTT()
            sglnrho = jnp.stack([
                sum(sij[a, b] * glnrho[b] for b in range(3))
                for a in range(3)])
            sglnTT = jnp.stack([
                sum(sij[a, b] * glnTT[b] for b in range(3))
                for a in range(3)])
            fvisc = fvisc + muTT[None] * (
                pen.del2u() + (1.0 / 3.0) * pen.graddivu()
                + 2.0 * sglnrho + 2.0 * self.nu_cspeed * sglnTT)
            heat = heat + 2.0 * muTT * pen.sij2()
            ts.diffus(muTT)
        if ({"hyper3-sph", "hyper3_sph", "hyper3-cyl", "hyper3_cyl"}
                & set(self.ivisc)) and self.nu_hyper3 > 0.0:
            # polar-coordinate hyperdiffusion (viscosity.f90:445,1827-1843
            # lvisc_hyper3_polar): ν₃/π⁴ · δ⁶u · dline_1² per axis — RAW
            # mesh differences with only a d1² scale, so curvilinear
            # metric factors never blow it up near axes; CFL adds
            # ν₃/π⁴·dxmin⁴ (scaled by dxyz_6 in the integrator)
            d1 = pen.dline_1()
            pi4_1 = 1.0 / 97.40909103400243
            fvisc = fvisc + self.nu_hyper3 * pi4_1 * sum(
                pen.d6_raw("uu", a) * d1[a] ** 2 for a in range(3))
            dxmin = 1.0 / jnp.maximum(
                jnp.maximum(jnp.max(d1[0]), jnp.max(d1[1])),
                jnp.max(d1[2]))
            ts.diffus3(self.nu_hyper3 * pi4_1 * dxmin ** 4)
        if "hyper3-mesh" in self.ivisc and self.nu_hyper3_mesh > 0.0:
            d1 = pen.dline_1()
            # reference normalization: ν₃ᵐ/π⁵ · δ⁶u/60 · dline_1
            # (src/viscosity.f90:1857)
            pi5_1 = 1.0 / 306.0196847852814
            fvisc = fvisc + self.nu_hyper3_mesh * pi5_1 * sum(
                pen.d6_raw("uu", a) * d1[a] / 60.0 for a in range(3)
            )
            ts.advec_mesh(self.nu_hyper3_mesh * pi5_1
                          * jnp.sqrt(d1[0]**2 + d1[1]**2 + d1[2]**2))
        if not isinstance(fvisc, float):
            accumulate(df, "uu", fvisc)
        if not isinstance(heat, float):
            pen._cache["visc_heat"] = heat

    def after_timestep(self, state, grid, cfg, reg, eos, dt, t, key,
                       it=None):
        if self.limplicit_viscosity and self.nu > 0.0 and "uu" in state:
            from ..ops.poisson import diffuse_fft
            state = dict(state)
            state["uu"] = diffuse_fft(state["uu"], cfg.grid, self.nu, dt)
        return state

