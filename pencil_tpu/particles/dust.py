"""Dust particles with drag coupling (reference ``src/particles_dust.f90``,
7098 LoC — the core Lagrangian carrier, SURVEY.md §2.8).

State: positions xp (npar, 3) and velocities vp (npar, 3), integrated with
the same 2N-RK scheme as the gas (the reference integrates particles inside
the RK substeps via particles_timestep_first/second,
src/timestep.f90:131-172).

Physics: Epstein drag dv/dt = −(v − u(x_p))/τ_s, optional gravity, optional
back-reaction −ε·(u − v̄_p)/τ_s deposited onto the gas momentum (dust-to-gas
mass loading eps_dtog), TSC interpolation/deposition
(src/particles_map.f90)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import math

import jax
import jax.numpy as jnp

from ..ops.stencil import NGHOST
from ..physics.base import ModuleBase, accumulate
from .interp import deposit, interpolate


@dataclass(frozen=True)
class ParticlesDust(ModuleBase):
    name: ClassVar[str] = "particles"

    npar: int = 1024
    tausp: float = 1.0            # stopping time τ_s
    eps_dtog: float = 0.0         # dust-to-gas ratio (0 = no back-reaction)
    scheme: str = "tsc"           # 'ngp' | 'cic' | 'tsc'
    lgravz: bool = False
    gravz: float = 0.0
    # particle gravity profile (particles_dust.f90:3526 particle_gravity;
    # 'linear' → dvpz −= ν_epi²·z_p, :3607-3610)
    gravz_profile: str = ""
    nu_epicycle: float = 0.0
    init: str = "random"   # 'random' | 'equidistant' | 'random-cylindrical'
    vinit: str = "zero"           # 'zero' | 'gas' (match local gas velocity)
    # 'random-cylindrical' annulus (reference rp_int/rp_ext +
    # dustdensity_powerlaw, particles_dust.f90:1358)
    rp_int: float = 0.0
    rp_ext: float = 0.0
    dustdensity_powerlaw: float = 0.0
    # 'gaussian-z' scale height / 'random-box' sub-box / velocity inits
    # (particles_dust.f90 zp0, xp0..Lz0, delta_vp0, beta_glnrho_global
    # via the dragforce-equilibrium NSH solution :1975)
    zp0: float = 1.0
    xp0: float = 0.0
    yp0: float = 0.0
    zp0_box: float = 0.0
    Lx0: float = 0.0
    Ly0: float = 0.0
    Lz0: float = 0.0
    delta_vp0: float = 1.0
    beta_glnrho_global: tuple = (0.0, 0.0, 0.0)
    Omega: float = 0.0
    cs0: float = 1.0
    # particles_radius (src/particles_radius.f90 initap='constant') +
    # steady-state drag law (calc_draglaw_steadystate,
    # particles_dust.f90:6364-6432: 1/τ = 18·C_D·ν/((ρ_mat/ρ_g)·Cu·d²)
    # with Schiller-Naumann C_D(Re_p) and Stokes-Cunningham slip Cu)
    ap0: float = 0.0
    rhopmat: float = 0.0
    mean_free_path_gas: float = 0.0
    # per-particle radius / swarm-number state (particles_radius.f90
    # initap 'constant'/'lognormal', particles_number.f90 initnpswarm):
    # emitted into pstate as 'ap'/'npswarm' when requested (coagulation &
    # condensation physics operate on them)
    initap: str = ""
    a0_initdist: float = 0.0
    sigma_initdist: float = 0.2
    initnpswarm: str = ""
    np_swarm0: float = 0.0
    rhop_swarm0: float = 0.0
    nu_draglaw: float = 0.0       # lnu_draglaw override viscosity
    # streaming_coldstart eigenmode (particles_dust.f90:2495-2608):
    # amplxxp, kx_xxp, kz_xxp + 14 reals = Re/Im of coeff(1..7)
    amplxxp: float = 0.0
    kx_xxp: float = 0.0
    ky_xxp: float = 0.0
    kz_xxp: float = 0.0
    # full initxxp cascade (e.g. 'equidistant','shift' —
    # particles_dust.f90 init loop); `init` keeps the first entry
    init_list: tuple = ()
    coeff: tuple = ()
    # constant velocity added to every particle at init (the NSH drag
    # equilibrium baseline from particles_drag lset_drag_equilibrium)
    vp0: tuple = (0.0, 0.0, 0.0)
    # reference proc count (cparam ncpus) — nparmax/nparmin diagnostics
    # report per-RANK particle counts (max over ranks of npar_loc)
    ncpus_ref: int = 1
    # reference proc grid (cparam nprocx/y/z) — the nmigmax diagnostic
    # (particles_mpicomm.f90:523 max over ranks of nmig_leave) is emulated
    # by counting particles whose virtual-rank assignment changes during
    # the first RK substep
    procgrid: tuple = (1, 1, 1)
    # multi-species streaming instability (initial_condition/
    # streaming_instability.f90 + particles ldraglaw_simple): per-species
    # stopping times/loadings, 4(nspec+1)·2 flat si_ev floats, NSH
    # equilibria per species (vpx0, vpy0) from the Bai & Stone (2010)
    # linear solve (particles_sub.f90:1390 dragforce_equi_multispecies)
    npar_species: int = 1
    taus_species: tuple = ()
    # absolute per-species stopping times (particles_dust.f90:44
    # tausp_species; species from the global index by
    # jspec = ns·(ipar−1)/npar + 1, particles_sub.f90:39-54)
    tausp_species: tuple = ()
    # NSH init eps choice (particles_dust.f90:109
    # ldragforce_equi_global_eps, default .false. → LOCAL rhop/rho)
    ldragforce_equi_global_eps: bool = False
    # mass density per superparticle (particles_dust.f90:665:
    # rhop_swarm = eps_dtog·rhom/(npar/nwgrid) with the stratification-
    # aware rhom of :640-656)
    rhop_swarm: float = 0.0
    eps_species: tuple = ()
    si_ev: tuple = ()
    si_amp: float = 1e-6
    si_kx: float = 0.0
    si_kz: float = 0.0
    dlnrhodlnr: float = 0.0
    vp0_species: tuple = ()       # ((vpx0, vpy0), ...) per species
    rho0: float = 1.0
    ldragforce_gas_par: bool = False
    draglaw: str = "epstein"      # 'epstein' (τ = tausp) | 'steadystate'
    #                             | 'purestokes' (calc_draglaw_purestokes,
    #                               particles_dust.f90:6314-6362:
    #                               1/τ = 18ν/((ρ_mat/ρ_g)·(2a)²))
    # PARTICLES=particles_tracers: no vp state dynamics — particles move
    # with the linearly-interpolated gas velocity (particles_tracers.f90
    # dxxp_dt_pencil :560-585)
    ltracers: bool = False
    # PARTICLES_LYAPUNOV (particles_lyapunov.f90): per-particle velocity-
    # gradient matrix W (init δ_ij) and passive vector bp evolved by the
    # linearly-interpolated S_ij = ∂u_i/∂x_j: dW = S·W, dbp = S·bp
    llyapunov: bool = False
    bamp: float = 1e-2
    linit_largeb: bool = False
    kmode_forb: float = 3.0
    # PARTICLES_CAUSTICS (particles_caustics.f90): σ_ij (init 0) with
    # dσ = (1/τ)(S − σ) − σ·σ, d(lnVp) = Tr σ; per-step reset where
    # Tr σ < cutoff increments the blowup counter (:380-385)
    lcaustics: bool = False
    trsigma_cutoff: float = -1e10
    lstocunn1: bool = False
    # bcpy='rmv': particles crossing a non-periodic y boundary are removed
    # (particles_boundcond, particles_sub.f90); solid_cyl = (x0, y0, r)
    # removes particles entering an immersed cylinder (in_solid_cell,
    # solid_cells.f90:2388 — the 'deposition' in cylinder_deposition)
    bcpy: str = "p"
    solid_cyl: tuple = ()
    # charged grains (reference src/particles_charged.f90): Lorentz
    # acceleration (q/m)(E + v×B) with E = −dA/dt = −(u×B − ηJ)
    # (magnetic.f90:5506 lee_as_aux) interpolated at the particles;
    # m = rhodust·(4π/3)a³ per particle
    # PARTICLES_SELFGRAVITY: particles feel −∇φ_self interpolated to
    # their positions (particles_selfgravity.f90:229-290 dvvp_dt_selfgrav,
    # linear interpolation default)
    lselfgrav_par: bool = False
    lcharged: bool = False
    dust_charge: float = 0.0
    rhodust: float = 1.0
    lonly_eforce: bool = False
    lstokes_drag: bool = False
    fluid_mu: float = 0.0
    ap0_list: tuple = ()          # initap='constant' multi-radius draw
    # radius growth + swarm-number physics (particles_radius.f90
    # sweep-up :660-707 and lcondensation_simplified :814;
    # particles_number.f90 coagulation/fragmentation :192-320)
    lsweepup_par: bool = False
    lfragmentation_par: bool = False
    lcondensation_simplified: bool = False
    GS_condensation: float = 0.0
    # dust accretion growth da/dt = ξ·ρ/ρ₀ after t ≥ tstart
    # (particles_radius.f90:807-812 ldust_accretion,
    # tstart_condensation_par gate)
    ldust_accretion: bool = False
    xi_accretion: float = 0.0
    tstart_condensation: float = 0.0
    vthresh_sweepup: float = -1.0
    vthresh_coagulation: float = 0.0
    deltavp12_floor: float = 0.0
    deltavp22_floor: float = 0.0
    cdtps: float = 0.2
    cdtpf: float = 0.2

    # -- state ----------------------------------------------------------
    def init_particles(self, grid, spec, key, dtype):
        kx, kv = jax.random.split(key)
        si_extra = None
        lo = jnp.asarray([spec.x0, spec.y0, spec.z0], dtype)
        L = jnp.asarray([spec.Lx, spec.Ly, spec.Lz], dtype)
        if self.init == "random":
            xp = lo + L * jax.random.uniform(kx, (self.npar, 3), dtype)
        elif self.init == "streaming_coldstart":
            # Youdin & Goodman (2005) streaming-instability eigenmode
            # (particles_dust.f90:2495 streaming_coldstart): equidistant
            # x-z lattice, positions shifted into the wanted mode, vp
            # from the eigenvector coeff(1:3)
            import numpy as np
            npx = int(round(np.sqrt(self.npar / (spec.Lz / spec.Lx))))
            npz = self.npar // npx
            dxp = spec.Lx / npx
            dzp = spec.Lz / npz
            ix = np.repeat(np.arange(npx), npz)
            iz = np.tile(np.arange(npz), npx)
            xpv = spec.x0 + (ix + 0.5) * dxp
            zpv = spec.z0 + (iz + 0.5) * dzp
            kx, kz = self.kx_xxp, self.kz_xxp
            A = self.amplxxp
            k2 = 2.0 * (kx * kx + kz * kz)
            # sequential shifts exactly as the reference loop
            xpv = xpv - A / k2 * (kx * np.sin(kx * xpv + kz * zpv)
                                  + kx * np.sin(kx * xpv - kz * zpv))
            zpv = zpv - A / k2 * (kz * np.sin(kx * xpv + kz * zpv)
                                  - kz * np.sin(kx * xpv - kz * zpv))
            xpv = xpv + kx / k2 * A * A * np.sin(
                2.0 * (kx * xpv + kz * zpv))
            zpv = zpv + kz / k2 * A * A * np.sin(
                2.0 * (kx * xpv + kz * zpv))
            yc = spec.y0 + 0.5 * spec.Ly
            xp = jnp.asarray(np.stack(
                [xpv, np.full_like(xpv, yc), zpv], axis=1), dtype)
            c = self.coeff
            eta_vK = -0.5 * self.beta_glnrho_global[0] * self.cs0
            cx, cz = np.cos(kx * xpv), np.cos(kz * zpv)
            sx, sz = np.sin(kx * xpv), np.sin(kz * zpv)
            vpx = eta_vK * A * (c[0] * cx - c[1] * sx) * cz
            vpy = eta_vK * A * (c[2] * cx - c[3] * sx) * cz
            vpz = -eta_vK * A * (c[5] * cx + c[4] * sx) * sz
            vp_mode = jnp.asarray(np.stack([vpx, vpy, vpz], axis=1), dtype)
        elif self.init == "si_exact_mode":
            # multi-species streaming-instability exact wave mode
            # (initial_condition/streaming_instability.f90:249-454): per-
            # lattice-site per-species eigenmode position offsets from the
            # ρp eigencomponents, velocities = NSH equilibrium + eigenmode
            import numpy as np
            ns = self.npar_species
            npps = self.npar // ns
            npx = int(round(np.sqrt(spec.Lx * npps / spec.Lz)))
            npz = npps // npx
            dxp = spec.Lx / npx
            dzp = spec.Lz / npz
            # site-major, species-inner ordering (the reference k loop)
            iz_s = np.repeat(np.arange(npz), npx * ns)
            ix_s = np.tile(np.repeat(np.arange(npx), ns), npz)
            is_s = np.tile(np.arange(ns), npx * npz)
            xs = spec.x0 + (ix_s + 0.5) * dxp
            zs = spec.z0 + (iz_s + 0.5) * dzp
            kx, kz = self.si_kx, self.si_kz
            ev = np.asarray(self.si_ev, np.float64).reshape(-1, 2)
            evc = ev[:, 0] + 1j * ev[:, 1]      # 4*(ns+1) complex
            eps = np.asarray(self.eps_species, np.float64)
            amp_scale = self.si_amp * eps.sum() \
                / np.abs(evc[7::4]).sum()
            eta_vK = -0.5 * self.dlnrhodlnr * self.cs0
            c1 = kx * kx + kz * kz
            c1x = 0.5 / c1 if c1 > 0 else 0.0
            c2x = 1.0 / c1 ** 2 if c1 > 0 else 0.0
            c1z = c1x * kz
            c2z = c2x * kz ** 3
            c1x = c1x * kx
            c2x = c2x * kx ** 3
            ar_s = (amp_scale * evc[7::4].real / eps)[is_s]
            ai_s = (amp_scale * evc[7::4].imag / eps)[is_s]
            a1_s = 0.25 * (ar_s ** 2 - ai_s ** 2)
            a2_s = 0.5 * ar_s * ai_s
            a3_s = 0.25 * (ar_s ** 2 + ai_s ** 2)
            argx = kx * xs
            argz = kz * zs
            sinp, sinm = np.sin(argx + argz), np.sin(argx - argz)
            cosp, cosm = np.cos(argx + argz), np.cos(argx - argz)
            sinp2, sinm2 = np.sin(2 * (argx + argz)), np.sin(2 * (argx - argz))
            cosp2, cosm2 = np.cos(2 * (argx + argz)), np.cos(2 * (argx - argz))
            dxp1 = (-c1x * (ar_s * (sinp + sinm) + ai_s * (cosp + cosm)
                            - a1_s * (sinp2 + sinm2) - a2_s * (cosp2 + cosm2))
                    + c2x * (a2_s * np.cos(2 * argx)
                             + a1_s * np.sin(2 * argx)))
            dzp1 = (-c1z * (ar_s * (sinp - sinm) + ai_s * (cosp - cosm)
                            - a1_s * (sinp2 - sinm2) - a2_s * (cosp2 - cosm2))
                    + c2z * a3_s * np.sin(2 * argz))
            xpv = xs + dxp1
            zpv = zs + dzp1
            yc = spec.y0 + 0.5 * spec.Ly
            xp = jnp.asarray(np.stack(
                [xpv, np.full_like(xpv, yc), zpv], axis=1), dtype)
            # velocities: per-species NSH equilibrium + eigenmode
            vp0 = np.asarray(self.vp0_species, np.float64)   # (ns, 2)
            dv = amp_scale * eta_vK
            ck = np.cos(kx * xpv)
            sk = np.sin(kx * xpv)
            ckz = np.cos(kz * zpv)
            skz = np.sin(kz * zpv)
            evp = evc[4:4 + 4 * ns].reshape(ns, 4)           # per species
            e1, e2, e3 = (evp[is_s, 0], evp[is_s, 1], evp[is_s, 2])
            vpx = vp0[is_s, 0] + dv * (e1.real * ck - e1.imag * sk) * ckz
            vpy = vp0[is_s, 1] + dv * (e2.real * ck - e2.imag * sk) * ckz
            vpz = -dv * (e3.real * sk + e3.imag * ck) * skz
            vp_mode = jnp.asarray(np.stack([vpx, vpy, vpz], axis=1), dtype)
            nwgrid = 1
            for n_, L_ in ((spec.nx, 0), (spec.ny, 0), (spec.nz, 0)):
                if n_ > 1:
                    nwgrid *= n_
            rhopj = self.rho0 / (self.npar / (ns * nwgrid)) * eps
            si_extra = {
                # namelist taus is DIMENSIONLESS (Ω·t_stop); the stopping
                # TIME is taus/Ω (streaming_instability.f90:94
                # tausp_species = taus/omega)
                "taus": jnp.asarray(np.asarray(
                    self.taus_species)[is_s] / self.Omega, dtype),
                "rhopswarm": jnp.asarray(rhopj[is_s], dtype),
                "vp_eq": jnp.asarray(vp0[is_s], dtype),
            }
        elif self.init in ("nothing", "origin"):
            # 'nothing' leaves fp at its zero-initialised state (reference
            # init_particles 'nothing'); place at the box centre so the
            # particles are inside the domain on shifted boxes
            xp = (lo + 0.5 * L) * jnp.ones((self.npar, 3), dtype)
        elif self.init == "equidistant":
            # even per-axis particle lattice over the ACTIVE dims only
            # (2-D runs put one particle column per cell — reference
            # init 'equidistant', particles_dust.f90)
            active = [a for a in range(3) if spec.shape[a] > 1]
            n = int(round(self.npar ** (1.0 / max(len(active), 1))))
            axes = []
            for a in range(3):
                if a in active:
                    axes.append((jnp.arange(n, dtype=dtype) + 0.5) / n)
                else:
                    axes.append(jnp.asarray([0.5], dtype))
            xyz = jnp.stack(jnp.meshgrid(*axes, indexing="ij"), -1)
            xp = (lo + L * xyz.reshape(-1, 3))[: self.npar]
        elif self.init in ("random-cylindrical", "random-cyl"):
            # r drawn so the surface density follows a power law
            # (particles_dust.f90:1358: r^(2−p) uniform between the annulus
            # bounds), φ uniform, z uniform over the box
            k1, k2, k3 = jax.random.split(kx, 3)
            p = 2.0 - self.dustdensity_powerlaw
            ri = self.rp_int if self.rp_int > 0 else 0.1
            re = self.rp_ext if self.rp_ext > 0 else float(
                min(spec.x0 + spec.Lx, spec.y0 + spec.Ly))
            u = jax.random.uniform(k1, (self.npar,), dtype)
            rad = (ri ** p + u * (re ** p - ri ** p)) ** (1.0 / p)
            phi = 2.0 * jnp.pi * jax.random.uniform(k2, (self.npar,), dtype)
            zz = spec.z0 + spec.Lz * jax.random.uniform(
                k3, (self.npar,), dtype)
            if spec.nz == 1:
                zz = jnp.full((self.npar,), spec.z0 + 0.5 * spec.Lz, dtype)
            xp = jnp.stack([rad * jnp.cos(phi), rad * jnp.sin(phi), zz],
                           axis=-1)
        elif self.init == "gaussian-z":
            # x,y uniform; z ~ N(0, zp0) truncated to the box by a wrap
            # (reference rejection loop, particles_dust.f90:1635-1659 with
            # r0gaussz=1, qgaussz=0)
            k1, k2 = jax.random.split(kx)
            xy = lo[:2] + L[:2] * jax.random.uniform(
                k1, (self.npar, 2), dtype)
            zz = self.zp0 * jax.random.normal(k2, (self.npar,), dtype)
            if spec.nz > 1:
                # box-truncate (clip instead of the reference's redraw loop)
                zz = jnp.clip(zz, spec.z0, spec.z0 + spec.Lz)
            else:
                zz = jnp.full((self.npar,), spec.z0 + 0.5 * spec.Lz, dtype)
            xp = jnp.concatenate([xy, zz[:, None]], axis=1)
        elif self.init == "random-box":
            # uniform inside the sub-box [xp0, xp0+Lx0]×… (reference
            # particles_dust.f90 'random-box'; degenerate axes centred)
            b0 = jnp.asarray([self.xp0, self.yp0, self.zp0_box], dtype)
            bL = jnp.asarray([self.Lx0 or spec.Lx, self.Ly0 or spec.Ly,
                              self.Lz0 or spec.Lz], dtype)
            u = jax.random.uniform(kx, (self.npar, 3), dtype)
            xp = b0 + bL * u
            for a, n in enumerate(spec.shape):
                if n == 1:
                    c = (spec.x0 + 0.5 * spec.Lx, spec.y0 + 0.5 * spec.Ly,
                         spec.z0 + 0.5 * spec.Lz)[a]
                    xp = xp.at[:, a].set(c)
        else:
            raise NotImplementedError(self.init)
        if "shift" in self.init_list:
            # sinusoidal position shift on top of the equidistant lattice
            # (particles_dust.f90 'shift': xp_i −= k_i/k²·A·sin(k·xp),
            # components updated SEQUENTIALLY like the reference loop)
            k2 = self.kx_xxp ** 2 + self.ky_xxp ** 2 + self.kz_xxp ** 2
            if k2 > 0.0:
                for a, ka in enumerate((self.kx_xxp, self.ky_xxp,
                                        self.kz_xxp)):
                    ph = (self.kx_xxp * xp[:, 0] + self.ky_xxp * xp[:, 1]
                          + self.kz_xxp * xp[:, 2])
                    xp = xp.at[:, a].add(-ka / k2 * self.amplxxp
                                         * jnp.sin(ph))
        vp = jnp.zeros((self.npar, 3), dtype)
        if self.init in ("streaming_coldstart", "si_exact_mode"):
            vp = vp + vp_mode
        if any(v != 0.0 for v in self.vp0):
            vp = vp + jnp.asarray(self.vp0, dtype)
        if self.bcpy == "rmv" or self.solid_cyl:
            # removable particles carry an explicit active mask (the
            # reference compacts npar_loc instead; a mask keeps shapes
            # static for jit)
            self_active = jnp.ones((self.npar,), dtype)
        else:
            self_active = None
        if self.vinit == "random":
            # vp += delta_vp0·(2U−1) (particles_dust.f90 initvvp 'random')
            vp = vp + self.delta_vp0 * (
                2.0 * jax.random.uniform(kv, (self.npar, 3), dtype) - 1.0)
        elif self.vinit == "jeans-wave-dustpar-x":
            # linear Jeans-wave drag eigenmode (particles_dust.f90
            # 'jeans-wave-dustpar-x', rhs_poisson_const=1):
            # vpx −= A·(√(1+4τ²)−1)/(2·kx·τ)·sin(kx·x)
            if self.tausp > 0.0 and self.kx_xxp != 0.0:
                fac = (math.sqrt(1.0 + 4.0 * self.tausp ** 2) - 1.0) \
                    / (2.0 * self.kx_xxp * self.tausp)
                vp = vp.at[:, 0].add(-self.amplxxp * fac
                                     * jnp.sin(self.kx_xxp * xp[:, 0]))
        elif self.vinit in ("dragforce_equilibrium",
                            "dragforce-equilibrium"):
            # NSH (1986) drag equilibrium (particles_dust.f90:1975-2032)
            # is applied post-assembly by ``nsh_equilibrium_init`` once the
            # gas fields exist (the reference default samples the LOCAL
            # dust-to-gas ratio from the deposited rhop field)
            pass
        out = {"xp": xp, "vp": vp}
        if self.llyapunov:
            # W_ij init δ_ij; bp = bamp·U[0,1) per component
            # (particles_lyapunov.f90 init_particles_lyapunov)
            eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype).reshape(9),
                                   (self.npar, 9))
            out["wp"] = eye
            if self.linit_largeb:
                bx = self.bamp * jnp.sin(self.kmode_forb * xp[:, 0])
                out["bp"] = jnp.stack([bx, bx, bx], axis=-1)
            else:
                kb = jax.random.fold_in(key, 7)
                out["bp"] = self.bamp * jax.random.uniform(
                    kb, (self.npar, 3), dtype)
        if self.lcaustics:
            out["sigmap"] = jnp.zeros((self.npar, 9), dtype)
            out["lnVp"] = jnp.zeros((self.npar,), dtype)
            out["blowup"] = jnp.zeros((self.npar,), dtype)
        if si_extra is not None:
            out.update(si_extra)
        if self_active is not None:
            out["active"] = self_active
        if self.initap:
            ka = jax.random.fold_in(key, 3)
            if self.initap == "lognormal":
                # ln a ~ N(ln a0, σ) (particles_radius.f90 'lognormal')
                ap = self.a0_initdist * jnp.exp(
                    self.sigma_initdist
                    * jax.random.normal(ka, (self.npar,), dtype))
            elif len(self.ap0_list) > 1:
                # multiple radii: each particle draws one uniformly
                # (particles_radius.f90:146-152)
                idx = jax.random.randint(ka, (self.npar,), 0,
                                         len(self.ap0_list))
                ap = jnp.asarray(self.ap0_list, dtype)[idx]
            else:                          # 'constant'
                ap = jnp.full((self.npar,),
                              self.a0_initdist or self.ap0, dtype)
            out["ap"] = ap
        if self.initnpswarm:
            if self.initnpswarm == "constant_rhop" and self.rhopmat > 0.0:
                # n_swarm = ρ_swarm0/(4π/3 ρ_mat a³)
                # (particles_number.f90 'constant_rhop')
                vol = 4.1887902047863905 * self.rhopmat \
                    * out.get("ap", jnp.full((self.npar,), self.ap0,
                                             dtype)) ** 3
                out["npswarm"] = self.rhop_swarm0 / jnp.maximum(vol, 1e-300)
            else:
                out["npswarm"] = jnp.full((self.npar,),
                                          self.np_swarm0, dtype)
            # per-particle coagulation-event count of the last MC sweep
            # (particles_coagulation.f90:764-765 ncoll_par → ncoagpm)
            out["ncoagp"] = jnp.zeros((self.npar,), dtype)
        if (self.npar_species > 1 and "taus" not in out
                and len(self.tausp_species) >= self.npar_species):
            # per-species stopping times from the global particle index
            # (particles_sub.f90:39-54 assign_species; tausp_species
            # namelist particles_dust.f90:44)
            import numpy as np
            jsp = (np.arange(self.npar, dtype=np.int64)
                   * self.npar_species) // self.npar
            out["taus"] = jnp.asarray(
                np.asarray(self.tausp_species, np.float64)[jsp], dtype)
        if self.rhop_swarm > 0.0 and "rhopswarm" not in out:
            # uniform mass density per superparticle (particles_dust.f90
            # :665) — carried per particle so the back-reaction deposit and
            # rhop diagnostics see the stratification-aware normalisation
            out["rhopswarm"] = jnp.full((self.npar,), self.rhop_swarm,
                                        dtype)
        if self.procgrid[0] * self.procgrid[1] * self.procgrid[2] > 1:
            out["nmig"] = jnp.zeros((), dtype)
        return out

    def mig_count(self, xp_old, xp_new, spec):
        """Max over virtual ranks of particles leaving that rank between
        two position snapshots (particles_mpicomm.f90:471-524 nmig_leave →
        max_name(idiag_nmigmax)); rank layout iproc = ipx + nprocx·(ipy +
        nprocy·ipz) like the reference's proc grid."""
        pg = self.procgrid
        ncpu = pg[0] * pg[1] * pg[2]
        lo = jnp.asarray([spec.x0, spec.y0, spec.z0], xp_old.dtype)
        L = jnp.asarray([spec.Lx, spec.Ly, spec.Lz], xp_old.dtype)
        pgf = jnp.asarray(pg, xp_old.dtype)
        pgc = jnp.asarray([p - 1 for p in pg], jnp.int32)

        def rank(x):
            f = jnp.mod(x - lo, L) / L
            r = jnp.clip(jnp.floor(f * pgf).astype(jnp.int32), 0, pgc)
            return r[:, 0] + pg[0] * (r[:, 1] + pg[1] * r[:, 2])

        r0, r1 = rank(xp_old), rank(xp_new)
        moved = (r0 != r1).astype(jnp.int32)
        cnt = jnp.zeros((ncpu,), jnp.int32).at[r0].add(moved)
        return jnp.max(cnt).astype(xp_old.dtype)

    def nsh_equilibrium_init(self, fields, pstate, reg, spec):
        """initvvp='dragforce_equilibrium' (particles_dust.f90:1975-2032):
        Nakagawa-Sekiya-Hayashi drag equilibrium between gas and dust.

        By default (ldragforce_equi_global_eps=F) the dust-to-gas ratio is
        LOCAL: eps(x) = rhop/rho with rhop the deposited particle density;
        the gas gets  ux −= βx·ε·Ωτ/D·cs,  uy += βx·(1+ε+(Ωτ)²)/(2D)·cs
        per grid point and each particle  vpx += βx·Ωτ/D·cs,
        vpy += βx·(1+ε)/(2D)·cs  with ε sampled at its nearest grid point
        (D = (1+ε)²+(Ωτ)²; τ is the GLOBAL tausp even with species).
        Returns (fields, pstate) updated."""
        dtype = pstate["xp"].dtype
        bx = self.beta_glnrho_global[0]
        cs = self.cs0
        ot = self.Omega * self.tausp
        if self.ldragforce_equi_global_eps:
            eps3 = jnp.full(spec.shape, self.eps_dtog, dtype)
        else:
            rhop = self.rhop(pstate, None, spec)
            if "rho" in fields:
                rho = fields["rho"]
            elif "lnrho" in fields:
                rho = jnp.exp(fields["lnrho"])
            else:
                rho = jnp.ones(spec.shape, dtype)
            eps3 = rhop / rho
        den = (1.0 + eps3) ** 2 + ot ** 2
        if "uu" in fields:
            uu = fields["uu"]
            uu = uu.at[0].add(-bx * eps3 * ot / den * cs)
            uu = uu.at[1].add(bx * (1.0 + eps3 + ot ** 2) / (2.0 * den)
                              * cs)
            fields = dict(fields)
            fields["uu"] = uu
        # particle velocities: eps at the nearest grid point (the
        # reference's ineargrid sample, :2016-2022)
        g = NGHOST
        epsg = jnp.pad(eps3[None], ((0, 0), (g, g), (g, g), (g, g)),
                       mode="wrap")
        epsk = interpolate(epsg, pstate["xp"], spec, "ngp")[0]
        denk = (1.0 + epsk) ** 2 + ot ** 2
        vp = pstate["vp"]
        vp = vp.at[:, 0].add(bx * ot / denk * cs)
        vp = vp.at[:, 1].add(bx * (1.0 + epsk) / (2.0 * denk) * cs)
        pstate = dict(pstate)
        pstate["vp"] = vp.astype(dtype)
        return fields, pstate

    # -- dynamics -------------------------------------------------------
    def rhs_particles(self, pstate, pen, spec, df, ts,
                      mesh_axis_names=None, mesh_shape=(1, 1, 1)):
        """Returns d(pstate); adds drag back-reaction to the gas df.

        Sharded mode (reference particles_mpicomm's role): particle state
        is replicated across shards; each shard gathers/deposits only the
        particles inside its subdomain (owner masking), gathers are psum'd
        over the mesh, and deposit spill into ghost zones is shipped to the
        owning neighbour by the reverse halo exchange."""
        xp, vp = pstate["xp"], pstate["vp"]
        uu_slots = "uu" in pen.reg.slots
        sharded = bool(mesh_axis_names) and any(
            n is not None and s > 1
            for n, s in zip(mesh_axis_names, mesh_shape))
        origin = mask = None
        names = []
        g = 3
        nloc = tuple(d - 2 * g for d in pen.fg.shape[1:])
        if sharded:
            dxyz = jnp.asarray([spec.dx, spec.dy, spec.dz], xp.dtype)
            x0 = jnp.asarray([spec.x0, spec.y0, spec.z0], xp.dtype)
            idxs = []
            for a, n in enumerate(mesh_axis_names):
                if n is not None and mesh_shape[a] > 1:
                    idxs.append(jax.lax.axis_index(n).astype(xp.dtype))
                    names.append(n)
                else:
                    idxs.append(jnp.asarray(0.0, xp.dtype))
            nl = jnp.asarray(nloc, xp.dtype)
            origin = x0 + jnp.stack(idxs) * nl * dxyz
            fc = (xp - origin) / dxyz
            inb = (fc >= 0.0) & (fc < nl)
            mask = (inb[:, 0] & inb[:, 1] & inb[:, 2]).astype(xp.dtype)
        if uu_slots:
            ug = interpolate(pen.fg[pen.reg.slice("uu")], xp, spec,
                             self.scheme, origin=origin, mask=mask).T
            if sharded:
                for n in names:
                    ug = jax.lax.psum(ug, n)
        else:
            ug = jnp.zeros_like(vp)
        if self.draglaw == "purestokes":
            # 1/τ = 18ν/((ρ_mat/ρ_g)·(2a)²), kinematic ν from the
            # viscosity slot (calc_draglaw_purestokes :6314-6362)
            visc = pen.cfg.module("viscosity") if pen.cfg else None
            nu = float(visc.nu) if visc is not None else 0.0
            rname = "rho" if "rho" in pen.reg.slots else "lnrho"
            rg = interpolate(pen.fg[pen.reg.slice(rname)], xp, spec,
                             "cic", origin=origin, mask=mask)[0]
            if sharded:
                for n in names:
                    rg = jax.lax.psum(rg, n)
            if rname == "lnrho":
                rg = jnp.exp(rg)
            dia = 2.0 * (pstate["ap"] if "ap" in pstate
                         else jnp.full((xp.shape[0],), self.ap0, xp.dtype))
            tausp1 = 18.0 * nu / ((self.rhopmat / rg)
                                  * jnp.maximum(dia, 1e-30) ** 2)
        elif self.draglaw == "steadystate":
            # per-particle 1/τ (calc_draglaw_steadystate :6364): Re_p =
            # 2a_p|u−v|/ν, Schiller-Naumann C_D, Stokes-Cunningham slip
            visc = pen.cfg.module("viscosity") if pen.cfg else None
            nu = float(visc.nu) if visc is not None else 0.0
            rname = "rho" if "rho" in pen.reg.slots else "lnrho"
            rg = interpolate(pen.fg[pen.reg.slice(rname)], xp, spec,
                             "cic", origin=origin, mask=mask)[0]
            if sharded:
                for n in names:
                    rg = jax.lax.psum(rg, n)
            if rname == "lnrho":
                rg = jnp.exp(rg)
            if "ap" in pstate:
                dia = 2.0 * pstate["ap"]          # per-particle diameter
            else:
                dia = 2.0 * self.ap0
            # lnu_draglaw: use nu_draglaw instead of the gas viscosity
            # (particles_dust.f90 calc_draglaw_steadystate)
            nu = max(self.nu_draglaw or nu, 1e-30)
            rep = dia * jnp.sqrt(jnp.sum((ug - vp) ** 2, axis=1)) / nu
            cdrag = jnp.where(
                rep < 1.0, 1.0,
                jnp.where(rep > 1000.0, 0.44 * rep / 24.0,
                          1.0 + 0.15 * rep ** 0.687))
            lam = self.mean_free_path_gas
            if self.lstocunn1 or lam == 0.0:
                stocunn = 1.0
            else:
                dias = jnp.maximum(dia, 1e-30)
                stocunn = 1.0 + 2.0 * lam / dias * (
                    1.257 + 0.4 * jnp.exp(-0.55 * dias / lam))
            tausp1 = (18.0 * cdrag * nu
                      / ((self.rhopmat / rg) * stocunn * dia ** 2))
        elif "taus" in pstate:
            # per-species stopping times (ldraglaw_simple with the
            # multi-species SI init; particles_dust.f90 draglaw 'simple')
            tausp1 = 1.0 / pstate["taus"]
        else:
            tausp1 = 1.0 / self.tausp if self.tausp > 0.0 else 0.0
        act = pstate.get("active")
        t1 = tausp1[:, None] if getattr(tausp1, "ndim", 0) == 1 else tausp1
        dvp = -(vp - ug) * t1
        Sp = None
        if (self.llyapunov or self.lcaustics) and uu_slots:
            # S_ij = ∂u_i/∂x_j linearly interpolated at particle positions
            # (reference guij aux filled by hydro, hydro.f90:2986;
            # interpolate_linear in dlyapunov_dt_pencil/dcaustics_dt_pencil)
            uij = pen.uij()            # (3,3,nx,ny,nz) interior
            g9 = uij.reshape((9,) + uij.shape[2:])
            gpad = pen.cfg.grid.nghost if pen.cfg else 3
            g9 = jnp.pad(g9, ((0, 0), (gpad, gpad), (gpad, gpad),
                              (gpad, gpad)), mode="wrap")
            sv = interpolate(g9, xp, spec, "cic", origin=origin,
                             mask=mask)
            if sharded:
                for n_ in names:
                    sv = jax.lax.psum(sv, n_)
            Sp = sv.T.reshape(-1, 3, 3)             # (npar, i, j)
        pdrag_mod = pen.cfg.module("particles_drag") \
            if pen.cfg is not None else None
        if self.Omega != 0.0 and pdrag_mod is None:
            # Coriolis + shear epicycle on the particles
            # (particles_dust.f90 dvvp_dt: −2Ω×vp, + qshear·Ω·vpx ŷ);
            # handed over to the drag cell solve when PARTICLES_DRAG is
            # active (like the gas side)
            sh = pen.cfg.module("shear") if pen.cfg is not None else None
            q = sh.qshear if sh is not None else 0.0
            Om = self.Omega
            dvp = dvp.at[:, 0].add(2.0 * Om * vp[:, 1])
            dvp = dvp.at[:, 1].add(-(2.0 - q) * Om * vp[:, 0])
        if self.lgravz and self.gravz != 0.0:
            dvp = dvp.at[:, 2].add(self.gravz)
        if self.gravz_profile == "linear" and self.nu_epicycle != 0.0:
            # linear vertical gravity g_z = −ν_epi²·z_p
            # (particles_dust.f90:3607-3610)
            dvp = dvp.at[:, 2].add(-self.nu_epicycle ** 2 * xp[:, 2])
        if self.lselfgrav_par and "gpotself" in pen.reg.slots:
            # self-gravity on the particles: −∇φ interpolated (CIC, the
            # reference interpolate_linear default;
            # particles_selfgravity.f90:229-290)
            gphi = pen.grad("gpotself")
            gpad = pen.cfg.grid.nghost if pen.cfg else 3
            gg = jnp.pad(gphi, ((0, 0), (gpad, gpad), (gpad, gpad),
                                (gpad, gpad)), mode="wrap")
            gp = interpolate(gg, xp, spec, "cic", origin=origin,
                             mask=mask)
            if sharded:
                for n_ in names:
                    gp = jax.lax.psum(gp, n_)
            dvp = dvp - gp.T
        if self.lcharged and "aa" in pen.reg.slots and "ap" in pstate:
            # Lorentz force (particles_charged.f90:1689-1716):
            # a = (q/m)(E + v×B), E = −(u×B) + ηJ, m = ρ_d·(4π/3)a³
            mag = pen.cfg.module("magnetic") if pen.cfg else None
            eta_ = float(getattr(mag, "eta", 0.0)) if mag else 0.0
            bb = pen.bb()
            uu_g = pen.uu()
            jj = pen.jj()
            EE = jnp.stack([
                -(uu_g[1] * bb[2] - uu_g[2] * bb[1]) + eta_ * jj[0],
                -(uu_g[2] * bb[0] - uu_g[0] * bb[2]) + eta_ * jj[1],
                -(uu_g[0] * bb[1] - uu_g[1] * bb[0]) + eta_ * jj[2],
            ])
            gpad = 3
            stack = jnp.concatenate([bb, EE], axis=0)
            stack_g = jnp.pad(stack, ((0, 0), (gpad, gpad), (gpad, gpad),
                                      (gpad, gpad)), mode="wrap")
            vals = interpolate(stack_g, xp, spec, self.scheme,
                               origin=origin, mask=mask)
            if sharded:
                for n_ in names:
                    vals = jax.lax.psum(vals, n_)
            bbp = vals[0:3].T
            eep = vals[3:6].T
            mass = self.rhodust * 4.1887902047863905 * pstate["ap"] ** 3
            qbym = (self.dust_charge / mass)[:, None]
            if self.lonly_eforce:
                dvp = dvp + qbym * eep
            else:
                vxb = jnp.stack([
                    vp[:, 1] * bbp[:, 2] - vp[:, 2] * bbp[:, 1],
                    vp[:, 2] * bbp[:, 0] - vp[:, 0] * bbp[:, 2],
                    vp[:, 0] * bbp[:, 1] - vp[:, 1] * bbp[:, 0],
                ], axis=1)
                dvp = dvp + qbym * (eep + vxb)
            if self.lstokes_drag and self.fluid_mu > 0.0:
                one_by_tau = 4.5 * self.fluid_mu / (
                    pstate["ap"] ** 2 * self.rhodust)
                dvp = dvp + one_by_tau[:, None] * (ug - vp)
            # gyration CFL: dt1 ≥ |q/m|·|B| (cyclotron frequency)
            ts.max_rate(jnp.max(jnp.abs(qbym[:, 0])
                                * jnp.sqrt(jnp.sum(bbp ** 2, axis=1)))
                        / 0.2)
        if self.ltracers:
            # tracer particles ride the gas (particles_tracers.f90
            # dxxp_dt_pencil): dx_p/dt = u(x_p); no velocity dynamics
            dxp = ug
            dvp = jnp.zeros_like(vp)
        else:
            dxp = vp
        if act is not None:
            dvp = dvp * act[:, None]
            dxp = dxp * act[:, None]
        shear = pen.cfg.module("shear") if pen.cfg is not None else None
        if shear is not None:
            # background-shear advection of particle positions:
            # dy_p/dt += S·x_p (reference dxxp_dt, particles_dust.f90:
            # "dfp(iyp) −= qshear·Omega·xp" — independent of SAFI)
            dxp = dxp.at[:, 1].add(shear.S * xp[:, 0])
        if self.ldragforce_gas_par and "rhopswarm" in pstate and uu_slots:
            # back-reaction via per-particle swarm densities
            # (particles_dust.f90 ldragforce_gas_par with
            # lparticles_density: force density = Σ w·ρp_swarm·(v−u)/τ)
            mom = ((vp - ug) * t1 * pstate["rhopswarm"][:, None]).T
            if act is not None:
                mom = mom * act[None]
            fdrag = deposit(mom, xp, spec, nloc, self.scheme,
                            dtype=vp.dtype, origin=origin, mask=mask,
                            mesh_axis_names=mesh_axis_names,
                            mesh_shape=mesh_shape)
            accumulate(df, "uu", fdrag * pen.rho1())
        elif self.eps_dtog > 0.0 and uu_slots:
            # back-reaction: gas feels +ε ρ_p/ρ_g (v_p − u)/τ_s; deposit the
            # per-particle momentum-exchange then normalize by gas density.
            # Each particle carries mass m_p = ε·ρ₀·V_box/npar.
            mp = self.eps_dtog * jnp.exp(pen.eos.lnrho0 if pen.eos else 0.0) \
                * spec.Lx * spec.Ly * spec.Lz / self.npar
            dV = spec.dx * spec.dy * spec.dz
            mom = ((vp - ug) * t1 * (mp / dV)).T     # (3, npar) force dens.
            if act is not None:
                mom = mom * act[None]
            fdrag = deposit(mom, xp, spec, nloc, self.scheme,
                            dtype=vp.dtype, origin=origin, mask=mask,
                            mesh_axis_names=mesh_axis_names,
                            mesh_shape=mesh_shape)
            accumulate(df, "uu", fdrag * pen.rho1())
        # drag CFL: dt1_drag = (max(1/τ_s) + Σ_cell ε_k/τ_k)/cdtp_drag —
        # with gas back-reaction the per-cell mass-loading sum joins the
        # dust side (particles_dust.f90:4839-4908, cdtp_drag=0.2)
        t1flat = tausp1 if getattr(tausp1, "ndim", 0) == 1 \
            else jnp.full((xp.shape[0],), tausp1, xp.dtype)
        if act is not None:
            t1flat = t1flat * act
        dt1_dust = jnp.max(t1flat) if xp.shape[0] else 0.0
        dt1_gas = 0.0
        if (self.ldragforce_gas_par or self.eps_dtog > 0.0) and uu_slots \
                and xp.shape[0] > 0:
            if "rhopswarm" in pstate:
                mp_vcell = pstate["rhopswarm"]
            else:
                mp = (self.eps_dtog if self.eps_dtog > 0 else 1.0) \
                    * spec.Lx * spec.Ly * spec.Lz / self.npar
                mp_vcell = mp / (spec.dx * spec.dy * spec.dz)
            dep = deposit(t1flat * mp_vcell, xp, spec, nloc, "ngp",
                          dtype=xp.dtype, origin=origin, mask=mask,
                          mesh_axis_names=mesh_axis_names,
                          mesh_shape=mesh_shape)
            if origin is None and mask is None:
                # reference combines the two drag rates PER CELL before
                # taking the max (particles_dust.f90:4904: dt1_drag =
                # dt1_drag_dust + dt1_drag_gas, both nx-pencil arrays);
                # max_cell(max_p 1/τ) + max_cell(Σ ε/τ) overestimates
                # when the stiffest particle sits outside the most
                # mass-loaded cell — scatter-max 1/τ onto the grid and
                # add the fields instead
                from .interp import _cell_coords, NGHOST
                fc = _cell_coords(xp, spec, xp.dtype, None)
                idx = jnp.rint(fc).astype(jnp.int32) - NGHOST
                nxyz = (spec.nx, spec.ny, spec.nz)
                cs = []
                for d in range(3):
                    c = idx[:, d]
                    cs.append(jnp.mod(c, nxyz[d]) if spec.periodic[d]
                              else jnp.clip(c, 0, nxyz[d] - 1))
                flat = (cs[0] * nxyz[1] + cs[1]) * nxyz[2] + cs[2]
                dustmax = jnp.zeros((nxyz[0] * nxyz[1] * nxyz[2],),
                                    xp.dtype).at[flat].max(t1flat)
                ts.max_rate(jnp.max(
                    dustmax.reshape(nxyz) + dep * pen.rho1()) / 0.2)
            else:
                dt1_gas = jnp.max(dep * pen.rho1())
                ts.max_rate((dt1_dust + dt1_gas) / 0.2)
        else:
            ts.max_rate(dt1_dust / 0.2)
        out = {"xp": dxp, "vp": dvp}
        if Sp is not None and self.llyapunov:
            W = pstate["wp"].reshape(-1, 3, 3)
            out["wp"] = jnp.einsum("kij,kjl->kil", Sp, W).reshape(-1, 9)
            out["bp"] = jnp.einsum("kij,kj->ki", Sp, pstate["bp"])
        if Sp is not None and self.lcaustics:
            sig = pstate["sigmap"].reshape(-1, 3, 3)
            taup1c = (tausp1 if getattr(tausp1, "ndim", 0) == 1
                      else jnp.full((xp.shape[0],), tausp1, xp.dtype))
            dsig = (taup1c[:, None, None] * (Sp - sig)
                    - jnp.einsum("kij,kjl->kil", sig, sig))
            out["sigmap"] = dsig.reshape(-1, 9)
            out["lnVp"] = sig[:, 0, 0] + sig[:, 1, 1] + sig[:, 2, 2]
        asc = pen.cfg.module("ascalar") if pen.cfg is not None else None
        if "ap" in pstate and (self.lsweepup_par or self.lfragmentation_par
                               or self.lcondensation_simplified
                               or self.ldust_accretion
                               or (asc is not None
                                   and asc.lcondensation_rate
                                   and asc.G_condensation != 0.0)):
            ap = pstate["ap"]
            nsw = pstate.get("npswarm", jnp.ones_like(ap))
            dap = jnp.zeros_like(ap)
            dnsw = jnp.zeros_like(ap)
            pi = 3.141592653589793
            if self.lcondensation_simplified and self.GS_condensation != 0.0:
                # dapdt = GS/ap (particles_radius.f90:814)
                dap = dap + self.GS_condensation / ap
                ts.max_rate(jnp.max(jnp.abs(self.GS_condensation)
                                    / ap ** 2) / self.cdtps)
            if self.ldust_accretion and self.xi_accretion != 0.0:
                # da/dt = ξ_accretion·ρ(x_p)/ρ₀ once t ≥ tstart
                # (particles_radius.f90:807-812)
                rname = "rho" if "rho" in pen.reg.slots else "lnrho"
                rg_ = interpolate(pen.fg[pen.reg.slice(rname)], xp, spec,
                                  "ngp", origin=origin, mask=mask)[0]
                if sharded:
                    for n_ in names:
                        rg_ = jax.lax.psum(rg_, n_)
                if rname == "lnrho":
                    rg_ = jnp.exp(rg_)
                rho0_ = pen.eos.rho0 if pen.eos is not None else 1.0
                rate_ = self.xi_accretion * rg_ / rho0_
                if self.tstart_condensation > 0.0:
                    t_ = pen._cache.get("_t", 0.0)
                    rate_ = jnp.where(t_ >= self.tstart_condensation,
                                      rate_, 0.0)
                dap = dap + rate_
            if (asc is not None and asc.lcondensation_rate
                    and asc.G_condensation != 0.0):
                # condensation growth da/dt = G·ssat(x_p)/a with the NGP
                # supersaturation (particles_radius.f90:818, ascalar_ngp)
                ssat_ = pen._cache.get("ascalar_ssat")
                if ssat_ is None:
                    ssat_ = asc.ssat_field(pen)
                gpad_ = pen.cfg.grid.nghost if pen.cfg else 3
                sg_ = jnp.pad(ssat_[None],
                              ((0, 0), (gpad_, gpad_), (gpad_, gpad_),
                               (gpad_, gpad_)), mode="wrap")
                sk_ = interpolate(sg_, xp, spec, "ngp", origin=origin,
                                  mask=mask)[0]
                if sharded:
                    for n_ in names:
                        sk_ = jax.lax.psum(sk_, n_)
                dap = dap + asc.G_condensation * sk_ / ap
            if self.lsweepup_par and "cc" in pen.reg.slots:
                # grain growth by sweeping up the passive-scalar grains
                # (particles_radius.f90:660-707): da/dt =
                # 0.25·Δv·cc·ρ/ρ_mat; the cc field is depleted and the
                # sweep rate joins dt1 via cdtps
                ccg = interpolate(pen.fg[pen.reg.slice("cc")], xp, spec,
                                  "ngp", origin=origin, mask=mask)[0]
                rhog = interpolate(
                    pen.fg[pen.reg.slice(
                        "rho" if "rho" in pen.reg.slots else "lnrho")],
                    xp, spec, "ngp", origin=origin, mask=mask)[0]
                if "lnrho" in pen.reg.slots:
                    rhog = jnp.exp(rhog)
                dv12 = jnp.sqrt(jnp.sum((vp - ug) ** 2, axis=1)
                                + self.deltavp12_floor ** 2)
                okv = (dv12 <= self.vthresh_sweepup) \
                    | (self.vthresh_sweepup < 0.0)
                rate = jnp.where(okv, dv12, 0.0)
                dap = dap + 0.25 * rate * ccg * rhog / max(self.rhopmat,
                                                           1e-30)
                sweep = nsw * pi * ap ** 2 * rate      # per particle
                dep = deposit(sweep, xp, spec, nloc, "ngp",
                              dtype=vp.dtype, origin=origin, mask=mask,
                              mesh_axis_names=mesh_axis_names,
                              mesh_shape=mesh_shape)
                cc = pen.field("cc")
                accumulate(df, "cc", -dep * cc)
                ts.max_rate(jnp.max(dep) / self.cdtps)
            if self.lfragmentation_par:
                # same-cell pairwise collisions (particles_number.f90):
                # cdot = π(a_j+a_k)²·n_j·n_k·Δv; below
                # vthresh_coagulation the pair coagulates (n down, a up),
                # above it fragments (n down, mass → cc scalar)
                lo_ = jnp.asarray([spec.x0, spec.y0, spec.z0], xp.dtype)
                dx_ = jnp.asarray([max(spec.Lx, 1e-30) / spec.nx,
                                   max(spec.Ly, 1e-30) / spec.ny,
                                   max(spec.Lz, 1e-30) / spec.nz],
                                  xp.dtype)
                cell = jnp.floor((xp - lo_) / dx_).astype(jnp.int32)
                cid = (cell[:, 0] * spec.ny + cell[:, 1]) * spec.nz \
                    + cell[:, 2]
                same = (cid[:, None] == cid[None, :]) \
                    & ~jnp.eye(ap.shape[0], dtype=bool)
                dvjk = jnp.sqrt(jnp.sum(
                    (vp[:, None, :] - vp[None, :, :]) ** 2, axis=-1)
                    + self.deltavp22_floor ** 2)
                sig = pi * (ap[:, None] + ap[None, :]) ** 2
                cdot = jnp.where(same,
                                 sig * nsw[:, None] * nsw[None, :] * dvjk,
                                 0.0)
                iscoag = dvjk <= self.vthresh_coagulation
                # coagulation: each UNORDERED pair contributes −½cdot to
                # both members → ordered-sum row gives −½Σ_j cdot_kj
                coag_k = jnp.sum(jnp.where(iscoag, cdot, 0.0), axis=1)
                frag_k = jnp.sum(jnp.where(~iscoag, cdot, 0.0), axis=1)
                dnsw = dnsw - 0.5 * coag_k - frag_k
                dap = dap + (1.0 / 3.0) * (0.5 * coag_k) * ap \
                    / jnp.maximum(nsw, 1e-30)
                if "cc" in pen.reg.slots:
                    # fragmented mass returns to the scalar:
                    # dcc += ρ⁻¹·(4π/3)ρ_mat·Σ(a_j³+a_k³)cdot (nolog)
                    mflux = jnp.sum(jnp.where(
                        same & ~iscoag,
                        sig * nsw[:, None] * nsw[None, :] * dvjk
                        * (ap[:, None] ** 3 + ap[None, :] ** 3), 0.0),
                        axis=1) * 0.5
                    depm = deposit((4.0 / 3.0) * pi * self.rhopmat
                                   * mflux, xp, spec, nloc, "ngp",
                                   dtype=vp.dtype, origin=origin,
                                   mask=mask,
                                   mesh_axis_names=mesh_axis_names,
                                   mesh_shape=mesh_shape)
                    accumulate(df, "cc", depm * pen.rho1())
                ts.max_rate(jnp.max((0.5 * coag_k + frag_k)
                                    / jnp.maximum(nsw, 1e-30))
                            / self.cdtpf)
            out["ap"] = dap
            if "npswarm" in pstate:
                out["npswarm"] = dnsw
        if act is not None:
            out["active"] = jnp.zeros_like(act)
        for k, v in pstate.items():
            # carried-but-not-advected state (ap, npswarm, ...): zero
            # derivative so the RK tree combine has matching structure
            if k not in out:
                out[k] = jnp.zeros_like(v)
        return out

    def wrap_positions(self, pstate, spec):
        lo = jnp.asarray([spec.x0, spec.y0, spec.z0], pstate["xp"].dtype)
        L = jnp.asarray([spec.Lx, spec.Ly, spec.Lz], pstate["xp"].dtype)
        per = jnp.asarray([1.0 if p else 0.0 for p in spec.periodic],
                          pstate["xp"].dtype)
        wrapped = lo + jnp.mod(pstate["xp"] - lo, L)
        xp = jnp.where(per > 0.5, wrapped, pstate["xp"])
        out = {**pstate, "xp": xp}
        act = pstate.get("active")
        if act is not None:
            # bcpy='rmv': deactivate on leaving a non-periodic y boundary;
            # solid deposition: deactivate inside the cylinder
            # (in_solid_cell, solid_cells.f90:2388)
            if self.bcpy == "rmv" and not spec.periodic[1]:
                act = jnp.where((xp[:, 1] < spec.y0)
                                | (xp[:, 1] > spec.y0 + spec.Ly), 0.0, act)
            if self.solid_cyl:
                x0_, y0_, r_ = self.solid_cyl
                r2 = (xp[:, 0] - x0_) ** 2 + (xp[:, 1] - y0_) ** 2
                act = jnp.where(r2 < (r_ + self.ap0) ** 2, 0.0, act)
            out["active"] = act
        return out

    def rhop(self, pstate, pen, spec, shear_dy=None):
        """Particle mass density on the grid (reference rhop aux).
        ``shear_dy``: shear-periodic x-boundary offset for the deposit
        ghost fold."""
        if "rhopswarm" in pstate:
            # lparticles_density: each superparticle carries its own
            # swarm density (particles_density.f90 irhopswarm)
            return deposit(pstate["rhopswarm"], pstate["xp"], spec,
                           spec.shape, self.scheme,
                           dtype=pstate["xp"].dtype, shear_dy=shear_dy)
        mp = self.eps_dtog if self.eps_dtog > 0 else 1.0
        mp = mp * spec.Lx * spec.Ly * spec.Lz / self.npar
        dV = spec.dx * spec.dy * spec.dz
        ones = jnp.ones((pstate["xp"].shape[0],), pstate["xp"].dtype)
        return deposit(ones * (mp / dV), pstate["xp"], spec, spec.shape,
                       self.scheme, dtype=pstate["xp"].dtype,
                       shear_dy=shear_dy)


@dataclass(frozen=True)
class ParticlesDustSharded(ParticlesDust):
    """Scalable variant: particle state SHARDED over the device mesh in
    fixed-size per-shard buffers with migration — the JAX-native analog of
    the reference's block/brick decomposition + rank-to-rank migration
    (``src/particles_mpicomm_blocks.f90``; npar_mig overflow semantics).

    Layout: xp/vp are (ndev·cap, 3) arrays sharded along dim 0 over the
    flattened ('x','y','z') mesh, plus an ``active`` mask (ndev·cap,).
    Each device only ever touches its own (cap, 3) block, so memory and
    gather/deposit work are O(npar/ndev) instead of O(npar).

    Migration (once per step, after the position wrap): leavers are packed
    into a fixed ``mig`` buffer, all-gathered (cheap at ICI mesh sizes),
    and each shard claims the rows whose subdomain it owns.  Buffer
    overflow drops particles (reference: fatal error on npar_mig overflow;
    here: bounded loss, countable via the active-sum diagnostic).
    """

    name: ClassVar[str] = "particles"
    cap_factor: float = 2.0      # per-shard capacity / mean load
    mig_factor: float = 0.5      # migration buffer / capacity

    def capacity(self, ndev):
        import math
        return max(8, int(math.ceil(self.npar / ndev * self.cap_factor)))

    def init_particles(self, grid, spec, key, dtype, mesh_shape=(1, 1, 1)):
        import numpy as np
        base = ParticlesDust.init_particles(self, grid, spec, key, dtype)
        ndev = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
        cap = self.capacity(ndev)
        xp = np.asarray(base["xp"])
        vp = np.asarray(base["vp"])
        # owner block per particle (subdomain raster order = mesh order)
        lo = np.asarray([spec.x0, spec.y0, spec.z0])
        dd = np.asarray([spec.Lx / mesh_shape[0], spec.Ly / mesh_shape[1],
                         spec.Lz / mesh_shape[2]])
        ijk = np.clip(((xp - lo) / dd).astype(int), 0,
                      np.asarray(mesh_shape) - 1)
        owner = (ijk[:, 0] * mesh_shape[1] + ijk[:, 1]) * mesh_shape[2] \
            + ijk[:, 2]
        xp_b = np.zeros((ndev * cap, 3), xp.dtype)
        vp_b = np.zeros((ndev * cap, 3), vp.dtype)
        act = np.zeros((ndev * cap,), xp.dtype)
        for d in range(ndev):
            sel = np.where(owner == d)[0][:cap]
            xp_b[d * cap: d * cap + len(sel)] = xp[sel]
            vp_b[d * cap: d * cap + len(sel)] = vp[sel]
            act[d * cap: d * cap + len(sel)] = 1.0
            # park inactive slots at the subdomain origin (harmless weights)
            org = lo + dd * np.asarray([ijk_ for ijk_ in np.unravel_index(
                d, mesh_shape)])
            xp_b[d * cap + len(sel): (d + 1) * cap] = org + 0.5 * dd
        return {"xp": jnp.asarray(xp_b), "vp": jnp.asarray(vp_b),
                "active": jnp.asarray(act)}

    def rhs_particles(self, pstate, pen, spec, df, ts,
                      mesh_axis_names=None, mesh_shape=(1, 1, 1)):
        """Local-block dynamics: every particle in this shard's buffer is
        (by the migration invariant) inside the local subdomain, so
        interpolation reads the local ghosted tile directly — no psum."""
        xp, vp = pstate["xp"], pstate["vp"]
        active = pstate["active"]
        uu_slots = "uu" in pen.reg.slots
        g = 3
        nloc = tuple(d - 2 * g for d in pen.fg.shape[1:])
        names = [n for n in (mesh_axis_names or ()) if n is not None]
        origin = self._origin(spec, mesh_axis_names, mesh_shape, xp.dtype)
        if uu_slots:
            ug = interpolate(pen.fg[pen.reg.slice("uu")], xp, spec,
                             self.scheme, origin=origin, mask=active).T
        else:
            ug = jnp.zeros_like(vp)
        tausp1 = 1.0 / self.tausp if self.tausp > 0.0 else 0.0
        dvp = -(vp - ug) * tausp1 * active[:, None]
        if self.lgravz and self.gravz != 0.0:
            dvp = dvp.at[:, 2].add(self.gravz * active)
        if self.gravz_profile == "linear" and self.nu_epicycle != 0.0:
            dvp = dvp.at[:, 2].add(-self.nu_epicycle ** 2 * xp[:, 2]
                                   * active)
        dxp = vp * active[:, None]
        shear = pen.cfg.module("shear") if pen.cfg is not None else None
        if shear is not None:
            dxp = dxp.at[:, 1].add(shear.S * xp[:, 0] * active)
        if self.ldragforce_gas_par and "rhopswarm" in pstate and uu_slots:
            # back-reaction via per-particle swarm densities
            # (particles_dust.f90 ldragforce_gas_par with
            # lparticles_density: force density = Σ w·ρp_swarm·(v−u)/τ)
            mom = ((vp - ug) * tausp1 * pstate["rhopswarm"][:, None]
                   * active[:, None]).T
            fdrag = deposit(mom, xp, spec, nloc, self.scheme,
                            dtype=vp.dtype, origin=origin, mask=active,
                            mesh_axis_names=mesh_axis_names,
                            mesh_shape=mesh_shape)
            accumulate(df, "uu", fdrag * pen.rho1())
        elif self.eps_dtog > 0.0 and uu_slots:
            mp = self.eps_dtog * jnp.exp(pen.eos.lnrho0 if pen.eos else 0.0) \
                * spec.Lx * spec.Ly * spec.Lz / self.npar
            dV = spec.dx * spec.dy * spec.dz
            mom = ((vp - ug) * tausp1 * (mp / dV) * active[:, None]).T
            fdrag = deposit(mom, xp, spec, nloc, self.scheme,
                            dtype=vp.dtype, origin=origin, mask=active,
                            mesh_axis_names=mesh_axis_names,
                            mesh_shape=mesh_shape)
            accumulate(df, "uu", fdrag * pen.rho1())
        if tausp1 > 0.0:
            dt1_gas = 0.0
            if (self.ldragforce_gas_par or self.eps_dtog > 0.0) \
                    and uu_slots:
                # same gas-side mass-loading drag limit as the
                # replicated path (particles_dust.f90:4839-4908)
                if "rhopswarm" in pstate:
                    mp_vcell = pstate["rhopswarm"]
                else:
                    mp = (self.eps_dtog if self.eps_dtog > 0 else 1.0) \
                        * spec.Lx * spec.Ly * spec.Lz / self.npar
                    mp_vcell = mp / (spec.dx * spec.dy * spec.dz)
                dep = deposit(tausp1 * mp_vcell * active, xp, spec, nloc,
                              "ngp", dtype=xp.dtype, origin=origin,
                              mask=active,
                              mesh_axis_names=mesh_axis_names,
                              mesh_shape=mesh_shape)
                dt1_gas = jnp.max(dep * pen.rho1())
            ts.max_rate((tausp1 + dt1_gas) / 0.2)
        return {"xp": dxp, "vp": dvp, "active": jnp.zeros_like(active)}

    def _origin(self, spec, mesh_axis_names, mesh_shape, dtype):
        lo = jnp.asarray([spec.x0, spec.y0, spec.z0], dtype)
        if not mesh_axis_names:
            return lo
        dd = jnp.asarray([spec.Lx / mesh_shape[0], spec.Ly / mesh_shape[1],
                          spec.Lz / mesh_shape[2]], dtype)
        idxs = []
        for a, n in enumerate(mesh_axis_names):
            if n is not None and mesh_shape[a] > 1:
                idxs.append(jax.lax.axis_index(n).astype(dtype))
            else:
                idxs.append(jnp.asarray(0.0, dtype))
        return lo + jnp.stack(idxs) * dd

    def wrap_positions(self, pstate, spec, mesh_axis_names=None,
                       mesh_shape=(1, 1, 1)):
        """Periodic wrap + migration of leavers to their owning shard."""
        out = ParticlesDust.wrap_positions(self, pstate, spec)
        names = [n for n in (mesh_axis_names or ()) if n is not None]
        if not names:
            return out
        xp, vp, active = out["xp"], out["vp"], out["active"]
        dtype = xp.dtype
        ndev = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
        cap = xp.shape[0]
        mig = max(8, int(cap * self.mig_factor))
        lo = jnp.asarray([spec.x0, spec.y0, spec.z0], dtype)
        dd = jnp.asarray([spec.Lx / mesh_shape[0], spec.Ly / mesh_shape[1],
                          spec.Lz / mesh_shape[2]], dtype)
        ijk = jnp.clip(jnp.floor((xp - lo) / dd).astype(jnp.int32), 0,
                       jnp.asarray(mesh_shape, jnp.int32) - 1)
        owner = (ijk[:, 0] * mesh_shape[1] + ijk[:, 1]) * mesh_shape[2] \
            + ijk[:, 2]
        my_id = jnp.asarray(0, jnp.int32)
        mults = (mesh_shape[1] * mesh_shape[2], mesh_shape[2], 1)
        for a, n in enumerate(mesh_axis_names):
            if n is not None and mesh_shape[a] > 1:
                my_id = my_id + jax.lax.axis_index(n) * mults[a]
        act_b = active > 0.5
        leaving = act_b & (owner != my_id)
        # pack leavers first (stable argsort on ¬leaving)
        order = jnp.argsort(jnp.where(leaving, 0, 1), stable=True)
        pick = order[:mig]
        buf_valid = leaving[pick]
        buf = jnp.concatenate([
            xp[pick], vp[pick],
            owner[pick].astype(dtype)[:, None],
            buf_valid.astype(dtype)[:, None]], axis=1)      # (mig, 8)
        # deactivate ALL leavers (overflow beyond mig is dropped — bounded
        # loss, like the reference's npar_mig hard limit)
        active = jnp.where(leaving, 0.0, active)
        # gather every shard's buffer; claim rows owned here
        allbuf = buf[None]
        for n in names:
            allbuf = jax.lax.all_gather(allbuf, n)
            allbuf = allbuf.reshape((-1,) + buf.shape)
        allbuf = allbuf.reshape(-1, 8)                       # (ndev·mig, 8)
        take = (allbuf[:, 7] > 0.5) & \
            (allbuf[:, 6].astype(jnp.int32) == my_id)
        inorder = jnp.argsort(jnp.where(take, 0, 1), stable=True)
        inc = allbuf[inorder]
        ninc = inc.shape[0]
        take_sorted = take[inorder]
        # free slots (inactive) packed first
        free_order = jnp.argsort(jnp.where(active > 0.5, 1, 0), stable=True)
        # place the k-th incoming into the k-th free slot (k < cap)
        k = jnp.arange(ninc)
        slot = jnp.where(k < cap, free_order[jnp.minimum(k, cap - 1)], 0)
        free_ok = active[slot] < 0.5
        ok = take_sorted & (k < cap) & free_ok
        xp = xp.at[slot].set(jnp.where(ok[:, None], inc[:, 0:3], xp[slot]))
        vp = vp.at[slot].set(jnp.where(ok[:, None], inc[:, 3:6], vp[slot]))
        active = active.at[slot].set(
            jnp.where(ok, 1.0, active[slot]))
        return {"xp": xp, "vp": vp, "active": active}
