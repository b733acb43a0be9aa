"""Superparticle coagulation (reference ``src/particles_coagulation.f90``):
Monte-Carlo collisions between particle swarms, each superparticle k
representing ``np_swarm_k`` identical physical particles of radius ``ap_k``.

Reference scheme (particles_coagulation_pencils :286-530): within each
grid cell, for pairs (j,k) of superparticles the inverse collision
time-scale is

    τ⁻¹ = Δv_jk · π (a_j + a_k)² · n                 (physical kernel)
    τ⁻¹ = K(a_j, a_k) · n                            (kernel tests)

with n = min/max(n_j, n_k) depending on the model; a uniform random
number accepts the collision when u < dt·τ⁻¹, and the outcome updates
radii/number densities conserving each swarm's mass density
(coagulation_fragmentation :879).

JAX-native design: instead of the reference's shepherd/neighbour linked
lists (inherently sequential per cell), one jitted sweep evaluates ALL
pairs masked by same-cell membership — an O(N²) bitmask einsum that
vectorises onto the VPU; collisions within a step sample the step-start
state (order-free), which converges to the same Smoluchowski limit.
The symmetric ('simultaneous') outcome merges both swarms like the
reference 'standard' droplet model; the asymmetric default doubles the
representative mass against lighter swarms (m_k → 2m_k) and absorbs
bigger ones (m_k → m_k + m_j), keeping ρ_swarm = m·n constant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax
import jax.numpy as jnp

from ..physics.base import ModuleBase

FOUR_PI_OVER_3 = 4.1887902047863905


@dataclass(frozen=True)
class ParticlesCoagulation(ModuleBase):
    """Bolted onto a particles module: operates on pstate keys
    'xp', 'vp', 'ap' (radius), 'npswarm' (swarm number density)."""
    name: ClassVar[str] = "particles_coagulation"

    rhopmat: float = 1.0            # material density of the solids
    kernel: str = "physical"        # 'physical' | 'constant' | 'linear'
    kernel_cst: float = 1.0
    kernel_lin: float = 1.0
    lcoag_simultaneous: bool = True
    lnoselfcollision: bool = True

    def sweep(self, pstate, spec, dt, key):
        """One MC collision sweep; returns the updated pstate."""
        xp = pstate["xp"]
        vp = pstate["vp"]
        ap = pstate["ap"]
        nsw = pstate["npswarm"]
        npar = xp.shape[0]

        # same-cell mask (reference: collisions only within a grid cell)
        lo = jnp.asarray([spec.x0, spec.y0, spec.z0], xp.dtype)
        dx = jnp.asarray([spec.Lx / spec.nx, spec.Ly / spec.ny,
                          spec.Lz / spec.nz], xp.dtype)
        cell = jnp.floor((xp - lo) / dx).astype(jnp.int32)
        ncell = jnp.asarray([spec.nx, spec.ny, spec.nz])
        cid = (cell[:, 0] * ncell[1] + cell[:, 1]) * ncell[2] + cell[:, 2]
        same = cid[:, None] == cid[None, :]

        dv = jnp.sqrt(jnp.sum(
            (vp[:, None, :] - vp[None, :, :]) ** 2, axis=-1) + 1e-300)
        aj = ap[None, :]
        ak = ap[:, None]
        nj = nsw[None, :]
        nk = nsw[:, None]
        if self.kernel == "constant":
            K = jnp.full_like(dv, self.kernel_cst)
        elif self.kernel == "linear":
            K = self.kernel_lin * FOUR_PI_OVER_3 * self.rhopmat * \
                (aj ** 3 + ak ** 3)
        else:
            K = dv * jnp.pi * (aj + ak) ** 2
        neff = jnp.maximum(nj, nk) if self.lcoag_simultaneous \
            else jnp.minimum(nj, nk)
        prob = dt * K * neff
        if self.lnoselfcollision:
            prob = jnp.where(jnp.eye(npar, dtype=bool), 0.0, prob)
        prob = jnp.where(same, prob, 0.0)
        u = jax.random.uniform(key, (npar, npar), xp.dtype)
        # symmetrise the draw so (j,k) and (k,j) decide together
        u = jnp.minimum(u, u.T)
        hit = u < prob

        # pick ONE partner per particle (the first hit) — parallel-safe
        partner = jnp.argmax(hit, axis=1)
        has = jnp.any(hit, axis=1)
        # mutual agreement: i's partner must also pick i
        mutual = has & (partner[partner] == jnp.arange(npar)) & \
            (partner != jnp.arange(npar))
        pj = jnp.where(mutual, partner, jnp.arange(npar))

        mp = FOUR_PI_OVER_3 * self.rhopmat * ap ** 3
        rhosw = mp * nsw                       # swarm mass density
        mpj = mp[pj]
        rhoj = rhosw[pj]
        if self.lcoag_simultaneous:
            # merge both swarms (reference droplet 'standard' outcome):
            # m_new = m_j + m_k, n_new = (ρ_j + ρ_k)/(2 m_new),
            # momentum-conserving velocity
            mnew = mp + mpj
            nnew = (rhosw + rhoj) / (2.0 * mnew)
            vnew = (vp * mp[:, None] + vp[pj] * mpj[:, None]) / mnew[:, None]
            anew = (mnew / (FOUR_PI_OVER_3 * self.rhopmat)) ** (1.0 / 3.0)
            ap = jnp.where(mutual, anew, ap)
            nsw = jnp.where(mutual, nnew, nsw)
            vp = jnp.where(mutual[:, None], vnew, vp)
        else:
            # asymmetric: k absorbs a bigger partner (m += m_j) or doubles
            # against a lighter swarm; ρ_swarm = m·n conserved
            mnew = jnp.where(mpj >= mp, mp + mpj, 2.0 * mp)
            anew = (mnew / (FOUR_PI_OVER_3 * self.rhopmat)) ** (1.0 / 3.0)
            nnew = rhosw / mnew
            ap = jnp.where(mutual, anew, ap)
            nsw = jnp.where(mutual, nnew, nsw)
        out = {**pstate, "ap": ap, "npswarm": nsw, "vp": vp}
        if "ncoagp" in pstate:
            # collisions-per-particle this sweep (reference ncoll_par,
            # particles_coagulation.f90:764-765)
            out["ncoagp"] = mutual.astype(ap.dtype)
        return out
