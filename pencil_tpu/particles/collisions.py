"""Monte-Carlo particle-particle collisions (reference
``src/particles_collisions.f90``: per-cell pairwise hard-sphere
collisions; each pair collides with probability n·σ·|Δv|·dt, the
post-collision velocities conserve momentum exactly and scale the
relative speed by the restitution coefficient with an isotropically
random scattering direction).

JAX-native: particles are sorted by flattened cell id (jax.lax.sort),
consecutive same-cell entries form candidate pairs, acceptance and
scattering angles are drawn per pair, and velocity updates scatter back
by sorted index — one fixed-shape pass, no per-cell lists."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax
import jax.numpy as jnp

from ..physics.base import ModuleBase


@dataclass(frozen=True)
class ParticlesCollisions(ModuleBase):
    name: ClassVar[str] = "particles_collisions"

    sigma_coll: float = 1.0       # collision cross-section per particle
    coeff_restitution: float = 1.0
    npswarm: float = 1.0          # physical particles per superparticle

    def integrate(self, pstate, spec, dt, key):
        """One MC collision sweep over dt: returns new pstate."""
        xp = pstate["xp"]
        vp = pstate["vp"]
        npar = xp.shape[0]
        dtype = vp.dtype
        ns = spec.shape
        dxs = jnp.asarray([spec.dx, spec.dy, spec.dz], dtype)
        x0 = jnp.asarray([spec.x0, spec.y0, spec.z0], dtype)
        ci = jnp.clip(((xp - x0) / dxs).astype(jnp.int32), 0,
                      jnp.asarray(ns) - 1)
        cell = (ci[:, 0] * ns[1] + ci[:, 1]) * ns[2] + ci[:, 2]
        order = jnp.argsort(cell)
        cell_s = cell[order]
        vp_s = vp[order]
        # candidate pairs: (2k, 2k+1) among sorted entries, same cell only
        even = vp_s[0::2]
        odd = vp_s[1::2]
        npair = min(even.shape[0], odd.shape[0])
        even = even[:npair]
        odd = odd[:npair]
        same = (cell_s[0:2 * npair:2] == cell_s[1:2 * npair:2])
        vrel = even - odd
        speed = jnp.sqrt(jnp.sum(vrel * vrel, axis=-1))
        # number density of collision partners in the cell
        dV = spec.dx * spec.dy * spec.dz
        rate = self.npswarm * self.sigma_coll * speed / dV
        k1, k2, k3 = jax.random.split(key, 3)
        accept = (jax.random.uniform(k1, (npair,), dtype)
                  < 1.0 - jnp.exp(-rate * dt)) & same
        # isotropic post-collision direction (hard-sphere scattering)
        mu = 2.0 * jax.random.uniform(k2, (npair,), dtype) - 1.0
        phi = 2.0 * jnp.pi * jax.random.uniform(k3, (npair,), dtype)
        st = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
        nhat = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), mu], -1)
        vcm = 0.5 * (even + odd)
        eps = self.coeff_restitution
        half = 0.5 * eps * speed[:, None] * nhat
        new_even = jnp.where(accept[:, None], vcm + half, even)
        new_odd = jnp.where(accept[:, None], vcm - half, odd)
        vp_s = vp_s.at[0:2 * npair:2].set(new_even)
        vp_s = vp_s.at[1:2 * npair:2].set(new_odd)
        inv = jnp.argsort(order)
        return {**pstate, "vp": vp_s[inv]}
