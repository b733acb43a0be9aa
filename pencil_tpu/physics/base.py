"""Physics-module protocol.

The reference declares a uniform per-module interface in ``src/*.h``
(register_X, init_X, calc_pencils_X, dX_dt, ... — SURVEY.md §1 L4).  Here a
module is a frozen dataclass (hashable → static under jit) with optional
hooks; an absent module is simply not composed in (replacing the ~100
``no<module>`` stub files of ``src/Makefile.src:11-138``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict

import jax.numpy as jnp


class TimestepAccum:
    """Per-point CFL accumulators (reference advec_*/maxdiffus*,
    ``src/equ.f90:916-931``).  Modules add; the integrator reduces."""

    def __init__(self):
        self.maxadvec = 0.0    # Σ_a |u_a|·dline_1_a  (linear advection terms)
        self.advec_cs2 = 0.0   # (cs² + vA²)·Σ_a Δ_a⁻²  (wave speeds, squared)
        self.advec2_hypermesh = 0.0  # Σ (ν₃ᵐ·π⁻⁵·√dxyz₂)² (mesh hyperdiff)
        self.maxdiffus = 0.0   # max(ν, η, χ, D) — scaled by dxyz_2 at the end
        self.maxdiffus3 = 0.0  # hyper-diffusivities — scaled by dxyz_6

    def advec(self, val):
        self.maxadvec = self.maxadvec + val

    def advec_mesh(self, val):
        """Mesh-hyperdiffusion advection-class rate.  Reference semantics
        (src/density.f90:2801-2803 etc.): each module adds
        (coef·π⁻⁵·√dxyz₂)² into advec2_hypermesh, whose square root joins
        maxadvec linearly (src/equ.f90:1100-1107)."""
        self.advec2_hypermesh = self.advec2_hypermesh + val * val

    def advec2(self, val):
        """Squared wave-speed CFL term (reference advec_cs2/advec_va2:
        combined as dt1_advec = sqrt(advec_uu² + advec_cs2)/cdt,
        src/equ.f90:916-931)."""
        self.advec_cs2 = self.advec_cs2 + val

    def diffus_scaled(self, val):
        """Diffusion rate with the line elements ALREADY folded in
        (reference modules that add d1-weighted rates straight into
        maxdiffus, e.g. meanfield_e_tensor diffus_special)."""
        self.maxdiffus_scaled = jnp.maximum(
            getattr(self, "maxdiffus_scaled", 0.0), val)

    def max_rate(self, val):
        """A rate that joins dt1_max directly by MAX (reference per-class
        dt1_... = max(dt1_..., rate) terms like particle drag)."""
        self.dt1_extra = jnp.maximum(getattr(self, "dt1_extra", 0.0), val)

    def diffus(self, val):
        self.maxdiffus = jnp.maximum(self.maxdiffus, val)

    def diffus3(self, val):
        self.maxdiffus3 = jnp.maximum(self.maxdiffus3, val)


def accumulate(df: Dict[str, jnp.ndarray], name: str, val: jnp.ndarray):
    if name in df:
        df[name] = df[name] + val
    else:
        df[name] = val


@dataclass(frozen=True)
class ModuleBase:
    """Base with no-op hooks; subclasses override what they provide."""

    name: ClassVar[str] = "base"

    def register(self, reg):
        """Claim f-array slots (reference register_X / farray.f90:99)."""

    def rhs(self, pen, df, ts):
        """Accumulate RHS contributions into df and CFL terms into ts
        (reference dX_dt inside the mn-loop, src/equ.f90:940-1058)."""

    def init_fields(self, grid, spec, eos, key, cfg=None):
        """Initial condition for this module's fields (reference init_X)."""
        return {}

    def before_timestep(self, state, grid, cfg, reg, eos, dt, t, key,
                        it=None):
        """Applied at the START of each full step (before RK substeps).
        Replay-mode forcing lands here so diagnostics sample the state at
        the same point as the reference time loop, which prints BEFORE
        addforce (src/run.f90:696-729): our state after step N then equals
        the reference's it=N time-series row."""
        return state

    def after_timestep(self, state, grid, cfg, reg, eos, dt, t, key,
                       it=None):
        """Applied once per full step outside the RK substeps (reference
        run.f90:729 addforce and X_after_timestep hooks).  ``it`` is the
        0-based index of the step just completed (traced int32)."""
        return state
