"""Non-Fourier (hyperbolic) heat-flux evolution (reference
``src/heatflux.f90``): the heat flux q becomes a dynamical field relaxing
toward the field-aligned Spitzer flux on a finite timescale τ,

    ∂q/∂t = −τ⁻¹·(q + K_spitzer ∇_∥T) + q(u·∇lnρ + ∇·u)      (lnfs2 form,
                                                               pp = q/ρ)
    ∂lnT/∂t −= γ/(cp·T)·(∇·q + q·∇lnρ)

which turns the parabolic Spitzer conduction into a telegraph equation
with propagation speed c = √(χγ/τ) — the explicit-stepping way to avoid the
χT^2.5 timestep collapse in hot coronal loops.  Implemented flavor:
iheatflux='spitzer' (non_fourier_spitzer :457-700) with the lnfs2=T
variable choice, saturation-flux limiting, and the ltau_spitzer_va
adaptive τ chosen so c = √2·v_A (optionally Boris-reduced via
va2max_tau_boris, :568-573).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax.numpy as jnp

from .base import ModuleBase, accumulate

_KSAT_SI = 7e7      # Ksaturation_SI (heatflux.f90:34)


@dataclass(frozen=True)
class HeatFlux(ModuleBase):
    name: ClassVar[str] = "heatflux"

    iheatflux: str = "spitzer"
    tau_inv_spitzer: float = 0.1
    Kspitzer_para: float = 0.0
    saturation_flux: float = 0.0
    Kc: float = 0.0                 # speed-of-light flux limiter (off: 0)
    lnfs2: bool = True              # evolve pp = q/ρ (the maintained form)
    ltau_spitzer_va: bool = True
    va2max_tau_boris: float = 0.0
    lreset_heatflux: bool = False
    cdts: float = 1.0               # run_pars cdts for the τ⁻¹ dt limit
    # code units for Ksaturation = 7e7 W/m²/K^1.5 (SI)
    unit_velocity: float = 1.0
    unit_temperature: float = 1.0
    clight_code: float = 0.0        # c in code units (for the Kc limiter)

    def register(self, reg):
        reg.register("qq", 3, "pde", comps=("qx", "qy", "qz"))

    @property
    def Ksaturation(self):
        return (_KSAT_SI / self.unit_velocity ** 3
                * self.unit_temperature ** 1.5)

    def _spitzer(self, pen):
        """(spitzer_vec, tau_inv, diffspitz, qsat_ratio, c_spitzer,
        c_spitzer0) — shared between the rhs and the q-diagnostics."""
        eos = pen.eos
        gam = eos.gamma
        cp1 = 1.0 / eos.cp
        tini = 1e-30
        lnTT = pen.lnTT()
        lnrho = pen.lnrho()
        glnTT = pen.glnTT()
        glnrho = pen.glnrho()
        bb = pen.bb()
        b2 = pen.b2()
        b2_1 = 1.0 / (b2 + tini)
        qq = pen.field("qq")
        d1 = pen.dline_1()

        # K·T^2.5/ρ for the pp=q/ρ form (heatflux.f90:485)
        Kspitzer = self.Kspitzer_para * jnp.exp(3.5 * lnTT - lnrho)
        # field-aligned Spitzer flux b̂(b̂·K∇lnT) (:517-519)
        KdotB = sum(Kspitzer * glnTT[a] * bb[a] for a in range(3))
        spitzer_vec = (b2_1 * KdotB)[None] * bb
        qsat_ratio = 1.0
        if self.saturation_flux != 0.0:
            # free-streaming saturation: harmonic mean of |q_sp| and
            # q_sat = sat·T^1.5·Ksat (:521-539)
            qabs = jnp.sqrt(sum(spitzer_vec[a] ** 2 for a in range(3)))
            qsat = (self.saturation_flux * jnp.exp(1.5 * lnTT)
                    * self.Ksaturation)
            qsat_c = 1.0 / (1.0 / qsat + 1.0 / (qabs + tini))
            ratio = jnp.where(qabs > jnp.sqrt(tini), qsat_c / (qabs + tini),
                              1.0)
            spitzer_vec = spitzer_vec * ratio[None]
            qsat_ratio = qsat / (qabs + jnp.sqrt(tini))
            pen._cache["hf_qsat_ratio"] = qsat_ratio

        tau_inv = self.tau_inv_spitzer
        diffspitz = None
        c_spitzer = c_spitzer0 = None
        if self.ltau_spitzer_va:
            # τ adapted so the telegraph speed is √2·v_A (:556-593),
            # bounded below by tau_inv_spitzer and above by the advective
            # rate so τ never becomes the stiffest mode
            gT2 = jnp.sqrt(sum(g ** 2 for g in glnTT) + tini)
            cosgT_b = sum(glnTT[a] / gT2 * bb[a] for a in range(3)) \
                * jnp.sqrt(b2_1)
            diffspitz = (self.Kspitzer_para
                         * jnp.exp(2.5 * lnTT - lnrho) * gam * cp1
                         * jnp.abs(cosgT_b))
            va2 = pen.va2()
            if self.va2max_tau_boris != 0.0:
                bor = (1.0 + (va2 / self.va2max_tau_boris) ** 2) ** -0.5
                tau_inv_va = 2.0 * va2 * bor / (diffspitz + jnp.sqrt(tini))
                dt1_va = jnp.sqrt(va2 * bor
                                  * sum(dd ** 2 for dd in d1))
            else:
                tau_inv_va = 2.0 * va2 / (diffspitz + jnp.sqrt(tini))
                dt1_va = jnp.sqrt(va2 * sum(dd ** 2 for dd in d1))
            uadv = 0.0
            if "uu" in pen.reg.slots:
                uu = pen.uu()
                uadv = sum(jnp.abs(uu[a]) * d1[a] for a in range(3))
            uplim = jnp.maximum(jnp.max(dt1_va), jnp.max(uadv + 0.0 * lnTT))
            tau_inv = jnp.clip(tau_inv_va, self.tau_inv_spitzer, uplim)
            c_spitzer = jnp.sqrt(diffspitz * tau_inv)
            c_spitzer0 = jnp.sqrt(diffspitz * self.tau_inv_spitzer)
        return spitzer_vec, tau_inv, diffspitz, qsat_ratio, \
            c_spitzer, c_spitzer0

    def _rhs_noadvection(self, pen, df, ts):
        """iheatflux='noadvection-spitzer' (heatflux.f90:793-910): q in
        physical units, no compression/advection coupling, fixed τ;
        dlnT/dt −= cv1·∇·q/(ρT) with the |rhs|/cdts and τ⁻¹/cdts dt
        limits.  For the ionization-EOS solar-atmosphere samples."""
        eos = pen.eos
        cv1 = eos.gamma / eos.cp
        tini = 1e-30
        lnTT = pen.lnTT()
        lnrho = pen.lnrho()
        glnTT = pen.glnTT()
        bb = pen.bb()
        b2_1 = 1.0 / (pen.b2() + tini)
        qq = pen.field("qq")
        d1 = pen.dline_1()
        chi = self.Kspitzer_para * jnp.exp(2.5 * lnTT - lnrho) * cv1
        if self.Kc != 0.0 and self.clight_code > 0.0:
            dmax = jnp.maximum(d1[0], d1[2])
            chi = jnp.minimum(chi, self.Kc * self.clight_code / dmax)
        # K∇T projected on b̂ (the ×T·ρ/cv1 restores K·T^2.5·∇T)
        coef = chi * pen.TT() * pen.rho() / cv1
        KdotB = sum(coef * glnTT[a] * bb[a] for a in range(3))
        spitzer_vec = (b2_1 * KdotB)[None] * bb
        accumulate(df, "qq",
                   -self.tau_inv_spitzer * (qq + spitzer_vec))
        divq = sum(pen.d("qq", a)[a] for a in range(3))
        rhs = cv1 * divq * pen.TT1() * pen.rho1()
        if "lnTT" in pen.reg.slots:
            accumulate(df, "lnTT", -rhs)
        ts.max_rate(jnp.abs(rhs) / self.cdts)
        ts.max_rate(self.tau_inv_spitzer / self.cdts + 0.0 * lnTT)
        ts.diffus(chi)

    def rhs(self, pen, df, ts):
        if self.iheatflux in ("nothing", ""):
            return
        if self.iheatflux in ("noadvection-spitzer",
                              "noadvection_spitzer"):
            return self._rhs_noadvection(pen, df, ts)
        if self.iheatflux != "spitzer" or not self.lnfs2:
            raise NotImplementedError(
                f"iheatflux={self.iheatflux!r} lnfs2={self.lnfs2} "
                "(only the lnfs2 'spitzer' flavor is implemented)")
        eos = pen.eos
        gam = eos.gamma
        cp1 = 1.0 / eos.cp
        tini = 1e-30
        lnTT = pen.lnTT()
        glnrho = pen.glnrho()
        qq = pen.field("qq")
        d1 = pen.dline_1()
        spitzer_vec, tau_inv, diffspitz, _qsr, c_spitzer, c_spitzer0 = \
            self._spitzer(pen)

        # flux relaxation + compression coupling (:591-598, lnfs2 sign)
        if "uu" not in pen.reg.slots:
            uglnrho = 0.0
        elif "lnrho" in pen.reg.slots:
            uglnrho = pen.ugrad("lnrho")
        else:
            uglnrho = pen.ugrad("rho") * pen.rho1()
        tau_b = tau_inv if isinstance(tau_inv, float) else tau_inv[None]
        out_q = -tau_b * (qq + spitzer_vec)
        if "uu" in pen.reg.slots:
            out_q = out_q + qq * (uglnrho + pen.divu())[None]
        accumulate(df, "qq", out_q)

        # energy equation: dlnT/dt −= γ·cp1·(∇·q + q·∇lnρ)/T (:617-634)
        divq = sum(pen.d("qq", a)[a] for a in range(3))
        qglnrho = sum(qq[a] * glnrho[a] for a in range(3))
        rhs = gam * cp1 * (divq + qglnrho) * jnp.exp(-lnTT)
        if "lnTT" in pen.reg.slots:
            accumulate(df, "lnTT", -rhs)
        elif "ss" in pen.reg.slots:
            # entropy form: ds = cv·dlnTT at fixed ρ
            accumulate(df, "ss", -rhs * eos.cp / gam)
        pen._cache["hf_divq"] = divq

        # CFL: telegraph propagation speed joins the advective class
        # (:646-683) and τ⁻¹ joins dt1_max directly
        if diffspitz is not None:
            dxmin_1 = jnp.maximum(jnp.maximum(
                jnp.max(d1[0]), jnp.max(d1[1])), jnp.max(d1[2]))
            ts.advec((0.36 * c_spitzer + 0.64 * c_spitzer0) * dxmin_1)
            ts.max_rate(tau_inv / self.cdts)
        else:
            ts.max_rate(self.tau_inv_spitzer / self.cdts + 0.0 * lnTT)

    def init_fields(self, grid, spec, eos, key, cfg=None):
        return {"qq": jnp.zeros((3, spec.nx, spec.ny, spec.nz))}
