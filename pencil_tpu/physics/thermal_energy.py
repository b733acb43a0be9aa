"""Thermal-energy equation (reference ``src/thermal_energy.f90`` — the
ENERGY slot variant that evolves the thermal energy density eth = ρcvT):

    ∂eth/∂t = −∇·(eth·u) − p∇·u + Γ_visc + χ·cp·∇·(ρ∇T) + χ_shock…
    p = (γ−1)·eth,  cs² = γ(γ−1)·eth/ρ,  fpres = −(γ−1)∇eth/ρ

With ``lweno_transport`` the advective term uses the WENO5 flux transport
(reference ``src/weno_transport.f90`` via p%transpeth; equ.f90:145 gating)
— this is the sod_10_WENO configuration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax
import jax.numpy as jnp

from .base import ModuleBase, accumulate


def weno_div_flux_3d(pen, name):
    """−∇·(q·u) via WENO5 along each axis (reference weno_transp).  The
    Lax–Friedrichs splitting speed is the reference's local ±3 running max
    of |u_a| computed on the ghosted block — shard-consistent because the
    halo supplies the window (see ops/weno.py).

    ``name``: a scalar slot name, or a tuple (vec, comp, scal) meaning
    q = vec[comp]·scal on the ghosted arrays (reference weno_transp's
    iq1>0 product, e.g. momentum ρ·u_j, hydro.f90:3163-3167).  Results are
    memoised in the pencil cache (density and hydro both need −∇·(uρ))."""
    key = ("weno_div", name)
    if key in pen._cache:
        return pen._cache[key]
    from ..ops.weno import weno5_div_flux
    from ..ops.stencil import i as interior
    if isinstance(name, tuple):
        vec, comp, scal = name
        qg = pen._gh(vec)[comp] * pen._gh(scal)[0]
    else:
        qg = pen._gh(name)[0]
    uug = pen._gh("uu")
    out = 0.0
    for a in range(3):
        if pen.cfg is not None and pen.cfg.grid.shape[a] == 1:
            continue
        term = weno5_div_flux(qg, uug[a], a, pen._inv(a), g=pen._g)
        rest = tuple(set((0, 1, 2)) - {a})
        out = out + interior(term[None], rest, g=pen._g)[0]
    pen._cache[key] = out
    return out


@dataclass(frozen=True)
class ThermalEnergy(ModuleBase):
    name: ClassVar[str] = "entropy"      # occupies the ENERGY slot

    chi: float = 0.0
    chi_shock: float = 0.0
    chi_hyper3_mesh: float = 0.0
    lweno_transport: bool = False
    lupw_eth: bool = False
    init: str = "const"
    eth_const: float = 1.0
    eth_left: float = 0.0
    eth_right: float = 0.0
    width: float = 0.05

    def register(self, reg):
        reg.register("eth", 1, "pde")

    def rhs(self, pen, df, ts):
        eos = pen.eos
        eth = pen.field("eth")
        gm1 = eos.gamma - 1.0
        divu = pen.divu()
        # transport + PdV work
        if self.lweno_transport:
            out = weno_div_flux_3d(pen, "eth")
        else:
            geth = pen.grad("eth")
            uu = pen.uu()
            out = -eth * divu - sum(uu[a] * geth[a] for a in range(3))
        out = out - gm1 * eth * divu             # p∇·u with p = (γ−1)eth
        # viscous heating: df(ieth) += ρ·visc_heat (viscosity.f90
        # calc_viscous_heat, lthermal_energy branch)
        heat = pen._cache.get("visc_heat")
        if heat is not None:
            out = out + heat * pen.rho()
        if self.chi != 0.0:
            # χ·cp·(ρ∇²T + ∇ρ·∇T)   (thermal_energy.f90:536) with
            # T = eth/(cv·ρ):  ∇T = (∇e − T·cv·∇ρ)/(cv·ρ),
            # ∇²T = [∇²e − 2∇lnρ·(∇e − e∇lnρ) − e(∇²ρ)/ρ]/(cv·ρ)
            cv1 = 1.0 / eos.cv
            rho, rho1 = pen.rho(), pen.rho1()
            glnrho = pen.glnrho()
            geth = pen.grad("eth")
            if "rho" in pen.reg.slots:
                del2rho = pen.del2s("rho")
            else:
                del2rho = rho * (pen.del2s("lnrho")
                                 + sum(g * g for g in glnrho))
            gTT = cv1 * rho1 * (geth - eth * glnrho)
            del2TT = cv1 * rho1 * (
                pen.del2s("eth")
                - 2.0 * sum(glnrho[a] * (geth[a] - eth * glnrho[a])
                            for a in range(3))
                - eth * rho1 * del2rho)
            grho = rho * glnrho
            out = out + self.chi * eos.cp * (
                rho * del2TT + sum(grho[a] * gTT[a] for a in range(3)))
            ts.diffus(eos.gamma * self.chi)
        if self.chi_shock != 0.0 and "shock" in pen.reg.slots:
            # χ_sh(shock·∇²eth + ∇shock·∇eth)   (thermal_energy.f90:546)
            shock = pen.field("shock")
            gshock = pen.grad("shock")
            geth = pen.grad("eth")
            out = out + self.chi_shock * (
                shock * pen.del2s("eth")
                + sum(gshock[a] * geth[a] for a in range(3)))
            ts.diffus(self.chi_shock * shock)
        if self.chi_hyper3_mesh != 0.0:
            # reference thermal_energy.f90:560 uses the raw δ⁶·dline form and
            # folds it into maxdiffus3 (its own convention, unlike entropy's)
            d1 = pen.dline_1()
            out = out + self.chi_hyper3_mesh * sum(
                pen.d6_raw("eth", a)[0] * d1[a] for a in range(3))
            ts.diffus3(self.chi_hyper3_mesh * (d1[0] + d1[1] + d1[2]))
        accumulate(df, "eth", out)

        # pressure force on the momentum (the reference adds p%fpres here,
        # thermal_energy.f90:502) — our hydro reads pen.fpres() which
        # dispatches on the 'eth' slot (see Pencils.fpres).  The advec_cs2
        # CFL term (thermal_energy.f90:496) is likewise added by Hydro —
        # the reference SETS advec_cs2, so adding it here too would
        # double-count it.

    def init_fields(self, grid, spec, eos, key, cfg=None):
        from .initcond import init_scalar
        if self.init in ("xjump", "yjump", "zjump"):
            return {"eth": init_scalar(self.init, grid, spec, eos, key,
                                       width=self.width,
                                       left=self.eth_left,
                                       right=self.eth_right)}
        base = init_scalar("zero", grid, spec, eos, key)
        return {"eth": base + self.eth_const}
