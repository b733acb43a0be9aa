"""Momentum equation (reference ``src/hydro.f90``, ``duu_dt`` at
:3613-3922):

    Du/Dt = −∇p/ρ + g + Fvisc + (J×B)/ρ − 2Ω×u [+ forcing]

Pressure, viscous, Lorentz and gravity terms are contributed by their own
modules; hydro owns advection, Coriolis, and the advective CFL accumulation
(``advec_uu = Σ_a (|u_a| + c_eff)·dline_1_a``, src/hydro.f90:3803-3810 plus
the eos advec_cs2 term folded in with the fast-magnetosonic speed)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import jax.numpy as jnp

from .base import ModuleBase, accumulate


@dataclass(frozen=True)
class Hydro(ModuleBase):
    name: ClassVar[str] = "hydro"

    Omega: float = 0.0        # rotation rate
    theta: float = 0.0        # angle of Ω from z-axis (degrees), as reference
    lupw_uu: bool = False
    lweno_transport: bool = False  # WENO momentum transport (hydro.f90:3736)
    # &run_pars lisotropic_advection: in <3D runs the advective CFL uses
    # the isotropic |u|·√(Σ dline⁻²) so a velocity along a degenerate
    # direction still limits dt (hydro.f90:3821-3823)
    lisotropic_advection: bool = False
    # FARGO orbital advection (cdata lfargo_advection; hydro.f90:2620,
    # 3557, 6928): advect with the residual of the φ-averaged azimuthal
    # flow, and shift f/df by the mean flow per substep (Fourier shift)
    lfargo_advection: bool = False
    lfargoadvection_as_shift: bool = True
    lpressuregradient_gas: bool = True   # reference hydro_run_pars flag
    init: str = "zero"
    ampl: float = 0.0
    kx: float = 1.0
    ky: float = 1.0
    kz: float = 1.0
    width: float = 0.1
    # global z1 reference height (cdata z1; 'up-down' centres its
    # gaussian on it, hydro.f90:2196)
    z1: float = 0.0
    uu_const: tuple = (0.0, 0.0, 0.0)   # init='const_uu' (hydro.f90:1691)
    # per-component (ampl, kx, ky, kz, phase) for the 'sinwave-phase' /
    # 'coswave-phase' / 'trilinear-y' families (reference ampl_ux… arrays)
    comp_pars: tuple = ()
    # per-entry overrides for list-valued inits (ninit cascades where the
    # reference pairs ampluu(j)/kz_uu(j) with inituu(j)): tuple of
    # ((field, value), ...) per init name
    init_list_pars: tuple = ()
    # global radial pressure-gradient parameter (density namelist
    # beta_glnrho_global) for 'sub-Keplerian' (hydro.f90:2231) and the
    # run-time global pressure-gradient force (noentropy.f90:379);
    # Omega_pressure = the rotation rate for beta scaling (kept separate
    # from Omega, which is zeroed when particles_drag takes the Coriolis)
    beta_glnrho_global: tuple = (0.0, 0.0, 0.0)
    # init-time override: samples may set beta_glnrho_global in
    # entropy_init_pars only (so the sub-Keplerian IC sees it) while the
    # run namelists leave it at 0 (no runtime pressure-gradient force) —
    # e.g. samples/2d-tests/Kelvin-Helmholtz-disc.  None → use
    # beta_glnrho_global for the IC too.
    beta_glnrho_init: tuple = None
    Omega_pressure: float = 0.0
    # constant velocity ADDED after any init (run-dir loader hook for the
    # NSH drag-equilibrium gas flow, particles_dust.f90:1999-2004)
    uu_add_const: tuple = (0.0, 0.0, 0.0)
    rnoise_int: float = 0.0   # radial band for 'gaussian-noise-rprof'
    rnoise_ext: float = 0.0   # (defaults to r_int/r_ext in the run dir)
    urand: float = 0.0   # additive uniform noise (hydro.f90:2518)
    # cylinder/sphere-in-a-box velocity damping (hydro.f90:5622 udamping):
    # outer zone relaxes u→0, inner zone (lOmega_int) toward solid-body
    # rotation Ω_int ẑ×r — the Taylor-Couette driving
    dampuext: float = 0.0
    dampuint: float = 0.0
    wdamp: float = 0.0
    # force-limited timestep (hydro.f90:3910-3916 lcdt_tauf): dt1_max ≥
    # |du/dt|_total/(cdt_tauf·ulev), applied to the ASSEMBLED df
    lcdt_tauf: bool = False
    cdt_tauf: float = 1.0
    ulev: float = 1.0
    lOmega_int: bool = False
    Omega_int: float = 0.0
    rdampint: float = 0.0     # defaults to r_int/r_ext from the run dir
    rdampext: float = 0.0
    lcylinder_in_a_box: bool = False
    # subtract the volume-mean momentum <ρu>/<ρ> each step (reference
    # remove_mean_momenta, hydro.f90:7346 — shearing-box wind guard)
    lremove_mean_momenta: bool = False

    def register(self, reg):
        reg.register("uu", 3, "pde", comps=("ux", "uy", "uz"))

    def after_timestep(self, state, grid, cfg, reg, eos, dt, t, key,
                       it=None):
        if not self.lremove_mean_momenta:
            return state
        uu = state["uu"]
        if "rho" in state:
            rho = state["rho"]
        elif "lnrho" in state:
            rho = jnp.exp(state["lnrho"])
        else:
            rho = jnp.ones_like(uu[0])
        rum = jnp.mean(rho[None] * uu, axis=(1, 2, 3))
        rm = jnp.mean(rho)
        state = dict(state)
        state["uu"] = uu - (rum / rm)[:, None, None, None]
        return state

    def adjust_df(self, pen, df, ts):
        # runs after every module's rhs (model post-pass): constrain dt by
        # the force as sampled at the END of duu_dt in the reference
        # (hydro.f90:3910-3916) — i.e. WITHOUT the pressure gradient
        # (added later by denergy_dt, entropy.f90:3299) and without the
        # gravity dispatches (equ.f90:990)
        if self.lcdt_tauf and "uu" in df:
            import jax.numpy as jnp
            duu = df["uu"] - pen.fpres()
            grav = pen._cache.get("_grav_duu")
            if grav is not None:
                duu = duu - grav
            ftot = jnp.max(jnp.abs(duu), axis=0)
            ts.max_rate(ftot / (self.cdt_tauf * self.ulev))

    def rhs(self, pen, df, ts):
        uu = pen.uu()
        if self.lweno_transport and "rho" in pen.reg.slots:
            # WENO flux-form advection (reference hydro.f90:3736-3743):
            # du_j −= (∇·(u·ρu_j) − u_j·∇·(u·ρ))·ρ⁻¹, both divergences by
            # WENO5 (transpurho with iq1=irho multiplies the ghosted fields)
            from .thermal_energy import weno_div_flux_3d
            rho1 = pen.rho1()
            drho = weno_div_flux_3d(pen, "rho")          # = −∇·(uρ)
            out = jnp.stack([
                (weno_div_flux_3d(pen, ("uu", j, "rho"))
                 - uu[j] * drho) * rho1
                for j in range(3)
            ])
        else:
            out = -pen.ugu()
        if self.lpressuregradient_gas:
            out = out + pen.fpres()
        if any(b != 0.0 for b in self.beta_glnrho_global):
            # global pressure-gradient force from the imposed radial
            # density gradient: du_j/dt −= cs²·β_j·Ω/cs0
            # (noentropy.f90:379-386 with beta_glnrho_scaled = β·Ω/cs0)
            cs2 = pen.cs2()
            cs0 = pen.eos.cs0 if pen.eos is not None else 1.0
            fac = self.Omega_pressure / cs0
            out = out - jnp.stack([
                cs2 * (self.beta_glnrho_global[a] * fac)
                for a in range(3)])
        if self.lupw_uu:
            # upwind dissipation per component: +|u_a|·δ⁶u/(60Δ)
            upw = sum(
                jnp.abs(uu[a])[None] * pen.d6_raw("uu", a) * pen._inv(a) / 60.0
                for a in range(3)
            )
            out = out + upw
        if self.Omega != 0.0:
            th = math.radians(self.theta)
            om = (self.Omega * math.sin(th), 0.0, self.Omega * math.cos(th))
            # −2Ω×u  (coriolis_cartesian, src/hydro.f90)
            out = out + (-2.0) * jnp.stack([
                om[1] * uu[2] - om[2] * uu[1],
                om[2] * uu[0] - om[0] * uu[2],
                om[0] * uu[1] - om[1] * uu[0],
            ])
        if (self.dampuext > 0.0 or self.dampuint > 0.0) \
                and (self.rdampext > 0.0 or self.rdampint > 0.0):
            # udamping (hydro.f90:5697-5765) — reproduced with the
            # reference's exact arithmetic: the PLAIN ext/int blocks
            # (spherical r) run in addition to the lOmega_int blocks
            # (cylindrical r for lcylinder_in_a_box), so with lOmega_int
            # the ext damping acts twice and the interior relaxes with
            # −dampuint·pd·(2u − Ω ẑ×r)
            g = pen.grid
            w = max(self.wdamp, 1e-30)
            r_sph = jnp.sqrt(g.xg ** 2 + g.yg ** 2 + g.zg ** 2) \
                + 0.0 * uu[0]

            def stepf(r, r0):
                return 0.5 * (1.0 + jnp.tanh((r - r0) / w))

            if self.dampuext > 0.0 and self.rdampext > 0.0:
                out = out - self.dampuext * stepf(r_sph,
                                                  self.rdampext) * uu
            if self.dampuint > 0.0 and self.rdampint > 0.0 \
                    and not self.lOmega_int:
                out = out - self.dampuint * (
                    1.0 - stepf(r_sph, self.rdampint)) * uu
            if self.lOmega_int and self.rdampext > 0.0:
                if self.lcylinder_in_a_box:
                    r2 = jnp.sqrt(g.xg ** 2 + g.yg ** 2) + 0.0 * uu[0]
                else:
                    r2 = r_sph
                out = out - self.dampuext * stepf(r2, self.rdampext) * uu
                if self.dampuint > 0.0 and self.rdampint > 0.0:
                    pd_int = 1.0 - stepf(r2, self.rdampint)
                    Om = self.Omega_int
                    out = out - self.dampuint * pd_int * jnp.stack([
                        uu[0] + g.yg * Om + 0.0 * uu[0],
                        uu[1] - g.xg * Om + 0.0 * uu[1],
                        uu[2]])
        accumulate(df, "uu", out)

        # advective CFL (reference split: advec_uu linear, advec_cs2/va2
        # squared — maxadvec = advec_uu + sqrt(advec_cs2), equ.f90:1100;
        # the Alfvén contribution is accumulated by Magnetic, anisotropic)
        d1 = pen.dline_1()
        gs = pen.cfg.grid if pen.cfg is not None else None
        dimensionality = (sum(n > 1 for n in (gs.nx, gs.ny, gs.nz))
                          if gs is not None else 3)
        if self.lisotropic_advection and dimensionality < 3:
            ts.advec(jnp.sqrt(pen.u2()
                              * (d1[0] ** 2 + d1[1] ** 2 + d1[2] ** 2)))
        else:
            # FARGO: the CFL uses the residual velocity, which is the
            # whole point of orbital advection (hydro.f90:3807-3810)
            uua = pen.uu_advec()
            ts.advec(sum(jnp.abs(uua[a]) * d1[a] for a in range(3)))
        if pen.eos is not None and ("lnrho" in pen.reg.slots
                                    or "rho" in pen.reg.slots) \
                and (pen.cfg is None
                     or pen.cfg.module("density_anelastic") is None):
            # gated on ldensity like the reference (energy module
            # denergy_dt: `if (... ldensity.and.lhydro) advec_cs2=...`) —
            # incompressible/Boussinesq/anelastic runs carry no
            # sound-speed CFL (acoustics are filtered out)
            ts.advec2(pen.cs2() * (d1[0] ** 2 + d1[1] ** 2 + d1[2] ** 2))

    def init_fields(self, grid, spec, eos, key, cfg=None):
        import dataclasses

        import jax

        from .initcond import init_vector
        if isinstance(self.init, (list, tuple)):
            # ninit cascade: each entry ADDS its profile (hydro.f90 init
            # loop `do j=1,ninit`)
            uu = 0.0
            for i, nm in enumerate(self.init):
                key, sub = jax.random.split(key)
                over = dict(self.init_list_pars[i]) \
                    if i < len(self.init_list_pars) else {}
                uu = uu + dataclasses.replace(
                    self, init=str(nm), init_list_pars=(), **over) \
                    .init_fields(grid, spec, eos, sub, cfg)["uu"]
            return {"uu": uu}
        import jax.numpy as jnp
        if self.init == "sub-Keplerian":
            # u −= cs²β̂_y/(2Ω) x̂ − cs²β̂_x/(2Ω) ŷ with β̂ = β·Ω/cs0
            # (hydro.f90:2231-2234; entropy.f90:906 beta_glnrho_scaled)
            # → ux = −cs0·β_y/2, uy = +cs0·β_x/2
            cs0 = eos.cs20 ** 0.5 if eos is not None else 1.0
            shape = (spec.nx, spec.ny, spec.nz)
            b = (self.beta_glnrho_init
                 if self.beta_glnrho_init is not None
                 else self.beta_glnrho_global)
            ux = jnp.full(shape, -0.5 * cs0 * b[1], grid.x.dtype)
            uy = jnp.full(shape, 0.5 * cs0 * b[0], grid.x.dtype)
            uu = jnp.stack([ux, uy, jnp.zeros_like(ux)])
        else:
            uu = init_vector(self.init, grid, spec, eos, key,
                             ampl=self.ampl, kx=self.kx, ky=self.ky,
                             kz=self.kz, width=self.width,
                             const3=self.uu_const,
                             rnoise_int=self.rnoise_int,
                             rnoise_ext=self.rnoise_ext,
                             comp_pars=self.comp_pars, z1=self.z1)
        if any(v != 0.0 for v in self.uu_add_const):
            uu = uu + jnp.asarray(self.uu_add_const,
                                  uu.dtype)[:, None, None, None]
        if self.urand != 0.0:
            # extra uniform perturbation u_i += urand·(U[0,1]−½)
            # (hydro.f90:2518-2526; urand<0 multiplicative flavor)
            key, sub = jax.random.split(key)
            r = jax.random.uniform(sub, uu.shape, uu.dtype)
            if self.urand > 0:
                uu = uu + self.urand * (r - 0.5)
            else:
                uu = uu * self.urand * (r - 0.5)
        return {"uu": uu}
