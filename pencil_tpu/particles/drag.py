"""Particle-in-cell mutual drag integrator (reference
``src/particles_drag.f90`` + the PIC machinery in
``src/particles_map_index.f90``).

The reference integrates gas-particle drag as an operator-split update
AFTER the full RK step (``split_update_particles``,
src/particles_main.f90:553-567 → ``integrate_drag``,
src/particles_drag.f90:231-274): particles are distributed to grid cells
with particle-mesh weights (TSC: ``pic_set_particles``
particles_map_index.f90:1027-1083, ``weigh_particle`` :1524), and each
cell solves the coupled drag + epicycle (shear/Coriolis) system EXACTLY
over dt (``drag_mutual_omega`` particles_drag.f90:519-642) around the
Nakagawa-Sekiya-Hayashi equilibrium.  When this module is active the
Coriolis force and shear acceleration are handed over from hydro/shear
(src/hydro.f90:1122, src/shear.f90:160) — configure Hydro with Omega=0
and the Shear module detects the handover itself.

JAX-native realization: the per-cell "list of particles" becomes a
segment-sum over flattened cell indices; the 3^d TSC sub-particle cloud
is a static python loop of d≤3 offset combinations; all per-cell
coefficients are elementwise arrays.  One fully-vectorized pass, no
sorting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax
import jax.numpy as jnp

from ..physics.base import ModuleBase


def _one_minus_exp(x):
    """1 − e^(−x) with the small-x series (reference sub.f90:5924)."""
    return jnp.where(x * x > 1e-12, 1.0 - jnp.exp(-x),
                     x * (1.0 - 0.5 * x))


def _tsc_w(d):
    """TSC weighting (reference tsc_weighting): 0.75−d² inner cell,
    0.5(1.5−|d|)² neighbours."""
    ad = jnp.abs(d)
    return jnp.where(ad < 0.5, 0.75 - d * d,
                     jnp.where(ad < 1.5, 0.5 * (1.5 - ad) ** 2, 0.0))


@dataclass(frozen=True)
class ParticlesDrag(ModuleBase):
    name: ClassVar[str] = "particles_drag"

    tdrag: float = 0.0            # drag time; or taus = Omega*tdrag
    taus: float = 0.0
    Omega: float = 0.0
    qshear: float = 1.5
    ldrag_on_par: bool = True
    ldrag_on_gas: bool = False
    eps_dtog: float = 0.0         # resets mp_swarm (find_mp_swarm)
    particle_mesh: str = "tsc"    # 'ngp' | 'tsc'
    # background gas pressure-gradient acceleration: dv_gas = gx_gas/2Ω
    # and the drag+epicycle solve acts on DEVIATIONS from the per-cell
    # NSH solution (drag_mutual_omega, particles_drag.f90:559-575)
    gx_gas: float = 0.0

    def _nsh(self, epstot):
        """Per-cell NSH solution (get_nsh_solution,
        particles_drag.f90:683-712)."""
        dvg = self.gx_gas / (2.0 * self.Omega)
        taus = self.taus if self.taus > 0 else self.Omega * self._tdrag()
        a = 1.0 + epstot
        b = dvg / (a * a + taus * taus)
        vx = -2.0 * taus * b
        vy = -a * b
        ux = -epstot * vx
        uy = -(a + taus * taus) * b
        return ux, uy, vx, vy

    def _tdrag(self):
        if self.tdrag > 0:
            return self.tdrag
        if self.taus > 0 and self.Omega != 0:
            return self.taus / self.Omega
        raise ValueError("particles_drag needs tdrag or taus+Omega")

    def integrate(self, fa, pstate, model, grid, dt, deltay=None):
        """Split drag update over dt: returns (fa, pstate) with uu and vp
        advanced by the per-cell analytic solution.

        ``deltay``: shearing-box y-offset of the x boundary.  A particle
        whose particle-mesh cloud wraps through x must reference the far
        side at y ∓ deltay (the reference exchanges ghost particles
        through the shear-offset neighbor machinery; without this the
        edge columns see phase-mismatched gas and a spurious boundary
        layer grows)."""
        if not (self.ldrag_on_par and self.ldrag_on_gas):
            raise NotImplementedError(
                "only ldrag_on_par + ldrag_on_gas (drag_on_both) is "
                "implemented; reference also rejects gas-only drag")
        reg = model.reg
        spec = model.cfg.grid
        eos = model.eos
        dtype = fa.dtype
        xp = pstate["xp"]
        vp = pstate["vp"]
        npar = xp.shape[0]
        tdrag = self._tdrag()

        active = [a for a in range(3) if spec.shape[a] > 1]
        dxs = (spec.dx, spec.dy, spec.dz)
        x0s = (spec.x0, spec.y0, spec.z0)
        ns = spec.shape
        dV = 1.0
        Lact = 1.0
        for a in active:
            dV *= dxs[a]
            Lact *= (spec.Lx, spec.Ly, spec.Lz)[a]
        rho0 = jnp.exp(eos.lnrho0) if eos is not None else 1.0
        mp_swarm = self.eps_dtog * rho0 * Lact / npar

        # gas fields at cells
        sl_uu = reg.slice("uu")
        uu = fa[sl_uu]                                # (3, nx, ny, nz)
        if "rho" in reg.slots:
            rho = fa[reg.slice("rho")][0]
        elif "lnrho" in reg.slots:
            rho = jnp.exp(fa[reg.slice("lnrho")][0])
        else:
            rho = jnp.ones(spec.shape, dtype)
        ncell = ns[0] * ns[1] * ns[2]
        rho_f = rho.reshape(ncell)
        ux_f = uu[0].reshape(ncell)
        uy_f = uu[1].reshape(ncell)
        uz_f = uu[2].reshape(ncell)

        # index-space positions (cell centers at integers) per active dim
        xi = []
        for a in range(3):
            if a in active:
                xi.append((xp[:, a] - x0s[a]) / dxs[a] - 0.5)
            else:
                xi.append(jnp.zeros((npar,), dtype))
        base = [jnp.round(x).astype(jnp.int32) for x in xi]

        # TSC cloud: 3 offsets per active dim (NGP: just 0)
        offs = (-1, 0, 1) if self.particle_mesh == "tsc" else (0,)
        import itertools
        per_ax = [offs if a in active else (0,) for a in range(3)]
        combos = list(itertools.product(*per_ax))
        dly_idx = (deltay / dxs[1]) if deltay is not None else None

        cells = []
        for (ox, oy, oz) in combos:
            w = jnp.ones((npar,), dtype)
            # x cell first — its wrap direction shear-offsets the y frame
            if 0 in active:
                cx = base[0] + ox
                if self.particle_mesh == "tsc":
                    w = w * _tsc_w(xi[0] - cx.astype(dtype))
                wrap = (cx < 0).astype(dtype) - (cx >= ns[0]).astype(dtype)
                cx = jnp.mod(cx, ns[0])
            else:
                cx = jnp.zeros((npar,), jnp.int32)
                wrap = jnp.zeros((npar,), dtype)
            if 1 in active:
                xi_y = xi[1]
                if dly_idx is not None:
                    # wrap low (cx<0 → far/high side): y_eff = y − deltay;
                    # wrap high: y_eff = y + deltay (matches the ghost
                    # slab shifts in parallel/halo.py fill_ghosts)
                    xi_y = xi_y - wrap * dly_idx
                by = jnp.round(xi_y).astype(jnp.int32)
                cy = by + oy
                if self.particle_mesh == "tsc":
                    w = w * _tsc_w(xi_y - cy.astype(dtype))
                cy = jnp.mod(cy, ns[1])
            else:
                cy = jnp.zeros((npar,), jnp.int32)
            if 2 in active:
                cz = base[2] + oz
                if self.particle_mesh == "tsc":
                    w = w * _tsc_w(xi[2] - cz.astype(dtype))
                cz = jnp.mod(cz, ns[2])
            else:
                cz = jnp.zeros((npar,), jnp.int32)
            idx = (cx * ns[1] + cy) * ns[2] + cz
            cells.append((idx, w))

        # per-cell aggregation of eps-weighted particle velocities
        epstot = jnp.zeros((ncell,), dtype)
        Svx = jnp.zeros((ncell,), dtype)
        Svy = jnp.zeros((ncell,), dtype)
        Svz = jnp.zeros((ncell,), dtype)
        eps_subs = []
        for idx, w in cells:
            eps_sub = mp_swarm * w / (dV * rho_f[idx])
            eps_subs.append(eps_sub)
            epstot = epstot.at[idx].add(eps_sub)
            Svx = Svx.at[idx].add(eps_sub * vp[:, 0])
            Svy = Svy.at[idx].add(eps_sub * vp[:, 1])
            Svz = Svz.at[idx].add(eps_sub * vp[:, 2])
        safe_eps = jnp.maximum(epstot, 1e-30)
        vxcm = Svx / safe_eps
        vycm = Svy / safe_eps

        t = dt / tdrag
        a0 = jnp.exp(-t)
        a3 = 1.0 + epstot
        ts_ = a3 * t
        a4 = jnp.exp(-ts_)
        a1 = (epstot + a4) / a3 - a0
        a2 = _one_minus_exp(ts_) / a3

        if self.Omega != 0.0:
            # epicyclic rotation coefficients (drag_mutual_omega): the
            # solve acts on deviations from the per-cell NSH equilibrium
            # set by gx_gas (zero offsets when gx_gas = 0)
            if self.gx_gas != 0.0:
                uxn, uyn, vxn, vyn = self._nsh(epstot)
            else:
                uxn = uyn = vxn = vyn = jnp.zeros_like(epstot)
            ux0_f = ux_f - uxn
            uy0_f = uy_f - uyn
            vxcm0 = vxcm - vxn
            vycm0 = vycm - vyn
            efreq = (2.0 * (2.0 - self.qshear)) ** 0.5 * self.Omega
            eratio = (2.0 / (2.0 - self.qshear)) ** 0.5
            ot = efreq * dt
            cosot = jnp.cos(ot)
            s = jnp.sin(ot)
            sinot1 = s * eratio
            sinot2 = s / eratio
            uxe = ux0_f * cosot + uy0_f * sinot1
            uye = uy0_f * cosot - ux0_f * sinot2
            vxe = vxcm0 * cosot + vycm0 * sinot1
            vye = vycm0 * cosot - vxcm0 * sinot2
            # gas update (ldrag_pm_back_reaction = F branch)
            a1g = (1.0 + epstot * a4) / a3
            a2g = epstot * a2
            dux_c = a1g * uxe + a2g * vxe - ux0_f
            duy_c = a1g * uye + a2g * vye - uy0_f
        else:
            x1me = _one_minus_exp(t)
            y1me = _one_minus_exp(ts_)
            zf = jnp.where(epstot > 1e-7,
                           a0 * _one_minus_exp(epstot * t) / safe_eps,
                           a0 * t * (1.0 - 0.5 * epstot * t))
            norm = 1.0 / a3
            uxcm = norm * (ux_f + Svx)
            uycm = norm * (uy_f + Svy)
            dux_c = (uxcm - ux_f) * y1me
            duy_c = (uycm - uy_f) * y1me

        # z component: plain mutual drag (drag_on_both z branch)
        x1me_z = _one_minus_exp(t)
        y1me_z = _one_minus_exp(ts_)
        zf_z = jnp.where(epstot > 1e-7,
                         a0 * _one_minus_exp(epstot * t) / safe_eps,
                         a0 * t * (1.0 - 0.5 * epstot * t))
        uzcm = (uz_f + Svz) / a3
        duz_c = (uzcm - uz_f) * y1me_z

        # particle velocity changes: weighted average over the cloud
        dvx = jnp.zeros((npar,), dtype)
        dvy = jnp.zeros((npar,), dtype)
        dvz = jnp.zeros((npar,), dtype)
        for (idx, w), eps_sub in zip(cells, eps_subs):
            if self.Omega != 0.0:
                vpx0 = vp[:, 0] - vxn[idx]
                vpy0 = vp[:, 1] - vyn[idx]
                dvx_s = (a1[idx] * vxe[idx] + a2[idx] * uxe[idx]
                         + a0 * (vpx0 * cosot + vpy0 * sinot1)
                         - vpx0)
                dvy_s = (a1[idx] * vye[idx] + a2[idx] * uye[idx]
                         + a0 * (vpy0 * cosot - vpx0 * sinot2)
                         - vpy0)
            else:
                ucm_x = (ux_f[idx] + Svx[idx]) / a3[idx]
                ucm_y = (uy_f[idx] + Svy[idx]) / a3[idx]
                du0x = ucm_x - ux_f[idx]
                du0y = ucm_y - uy_f[idx]
                dvx_s = (ucm_x - vp[:, 0]) * x1me - du0x * zf[idx]
                dvy_s = (ucm_y - vp[:, 1]) * x1me - du0y * zf[idx]
            du0z = uzcm[idx] - uz_f[idx]
            dvz_s = (uzcm[idx] - vp[:, 2]) * x1me_z - du0z * zf_z[idx]
            dvx = dvx + w * dvx_s
            dvy = dvy + w * dvy_s
            dvz = dvz + w * dvz_s

        vp_new = vp + jnp.stack([dvx, dvy, dvz], axis=-1)
        du = jnp.stack([dux_c.reshape(spec.shape),
                        duy_c.reshape(spec.shape),
                        duz_c.reshape(spec.shape)])
        fa = fa.at[sl_uu].add(du.astype(dtype))
        return fa, {**pstate, "vp": vp_new}
