"""Sink particles (reference ``src/particles_sink.f90``): superparticles
that exceed a density threshold become sinks (``create_particles_sink``
:240, triggered where the interpolated ρ_p > rhop_sink_create) and then
accrete every particle that comes within ``sink_radius``
(:600+ remove_particles_sink), conserving mass and momentum.

JAX-native design: sinks are flagged by a positive ``srad`` per-particle
field (the reference tags them with negative ``iaps``); both creation and
accretion are vectorised masked updates on fixed-size buffers — accreted
particles are deactivated (``active=False``) rather than compacted, which
keeps shapes static under jit, exactly like the sharded migration
buffers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax.numpy as jnp

from ..physics.base import ModuleBase


@dataclass(frozen=True)
class ParticlesSink(ModuleBase):
    name: ClassVar[str] = "particles_sink"

    sink_radius: float = 0.05
    rhop_sink_create: float = -1.0   # <0: never create, sinks preset only
    mp_swarm: float = 1.0            # mass per superparticle

    def sweep(self, pstate, spec, rhop_at=None):
        """One creation+accretion sweep.

        pstate keys: xp, vp, mp (per-particle mass), srad (sink radius,
        0 = regular particle), active (bool).  rhop_at: optional callable
        xp → interpolated particle density (for creation)."""
        xp = pstate["xp"]
        vp = pstate["vp"]
        mp = pstate["mp"]
        srad = pstate["srad"]
        active = pstate["active"]

        if self.rhop_sink_create > 0.0 and rhop_at is not None:
            rhop = rhop_at(xp)
            become = active & (srad == 0.0) & (rhop > self.rhop_sink_create)
            srad = jnp.where(become, self.sink_radius, srad)

        is_sink = active & (srad > 0.0)
        is_prey = active & (srad == 0.0)
        # pairwise distances sink_i × particle_j, periodic minimum image
        L = jnp.asarray([spec.Lx, spec.Ly, spec.Lz], xp.dtype)
        d = xp[:, None, :] - xp[None, :, :]
        d = d - L * jnp.round(d / L)
        r = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-300)
        within = (r < srad[:, None]) & is_sink[:, None] & is_prey[None, :]
        # each prey goes to the NEAREST claiming sink
        rmask = jnp.where(within, r, jnp.inf)
        owner = jnp.argmin(rmask, axis=0)
        eaten = jnp.isfinite(jnp.min(rmask, axis=0))
        # accumulate mass & momentum onto sinks (segment sum over owners)
        gain_m = jnp.zeros_like(mp).at[owner].add(
            jnp.where(eaten, mp, 0.0))
        gain_p = jnp.zeros_like(vp).at[owner].add(
            jnp.where(eaten[:, None], mp[:, None] * vp, 0.0))
        new_m = mp + gain_m
        new_v = jnp.where(is_sink[:, None] & (gain_m[:, None] > 0),
                          (mp[:, None] * vp + gain_p) /
                          jnp.maximum(new_m[:, None], 1e-300), vp)
        mp = jnp.where(is_sink, new_m, mp)
        vp = new_v
        active = active & ~eaten
        return {**pstate, "vp": vp, "mp": mp, "srad": srad,
                "active": active}
