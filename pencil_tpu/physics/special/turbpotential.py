"""Turbulent potential for dead-zone / MRI-emulating disks (reference
``src/special/turbpotential.f90``, Laughlin+04 / Baruteau & Lin 2010).

A table of ``nmode_max`` stochastic spiral modes (amplitude from a
Box-Muller draw, azimuthal wavenumber m log-uniform in [mmode_min,
mmode_max], radial center uniform in [rmodes_int, rmodes_ext], lifetime =
the mode's sound-crossing time 2πr/(m·cs)) builds a potential

    Φ(r,φ,z,t) = A(r) Σ_k ξ_k exp(−((r−r_k)/σ_k)²)
                 · cos(m_k φ − φ_k − (ω_k−Ω_corot)(t−t_k))
                 · (z − z_k) · sin(π (t−t_k)/τ_k)

with A(r) = r²Ω²(r) · 8.5e-2 · cs0 · sqrt(α) (turbpotential.f90:170-188)
and du/dt −= ∇Φ (f90:748-751).  Expired modes (age > lifetime) are
replaced by fresh draws (f90:414-455).

JAX-native design: the mode table is a (nmode_max,)-vector module state
(Model ``mstate`` channel), replaced data-parallel with ``jnp.where``
from ``jax.random`` draws — no host round trip; the potential is rebuilt
once per full step (the reference rebuilds per substep in
special_before_boundary; within-step phase drift is O(ω dt)) into the
comm_aux slot ``potturb`` whose gradient the momentum RHS consumes.  The
reference uses the Fortran intrinsic ``random_number`` here (not its
parity RNG), so cross-code trajectories are statistical, not bitwise.
Sample: samples/2d-tests/turbulent_potential.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import jax
import jax.numpy as jnp

from ..base import accumulate
from . import Special, register_special

NMODE_MAX = 50  # turbpotential.f90:88


@register_special("turbpotential")
@dataclass(frozen=True)
class TurbPotential(Special):
    name: ClassVar[str] = "turbpotential"

    alpha: float = 0.01
    temperature_power_law: float = 1.0
    lcalc_potturb: bool = True
    lturbulent_force: bool = True
    ltime_dependant_amplitude: bool = True
    lgravitational_turbulence: bool = False
    lcap_modes_at_m6: bool = False
    rmodes_int: float = None
    rmodes_ext: float = None
    r_int: float = 0.0
    r_ext: float = 0.0
    mmode_min: int = 1
    mmode_max: int = 0      # 0 → nygrid/8 (f90:89)
    gsum: float = 1.0       # gravity_r g0 (shared variable in the ref)

    def register(self, reg):
        reg.register("potturb", 1, "comm_aux")

    # ---- mode table -------------------------------------------------------
    def _bounds(self, cfg):
        ri = self.rmodes_int if self.rmodes_int is not None else self.r_int
        re = self.rmodes_ext if self.rmodes_ext is not None else self.r_ext
        if re == 0.0:
            gs = cfg.grid
            ri = ri or gs.x0
            re = gs.x0 + gs.Lx
        mmax = self.mmode_max or max(cfg.grid.ny // 8, 1)
        return float(ri), float(re), int(mmax)

    def _draw_modes(self, key, t, cfg, eos, n=NMODE_MAX):
        """Vectorized get_mode (turbpotential.f90:506-623)."""
        ri, re, mmax = self._bounds(cfg)
        cs0 = getattr(eos, "cs0", 1.0)
        logmin, logmax = math.log(self.mmode_min), math.log(mmax)
        k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
        u = jax.random.uniform(k1, (n,))
        m = jnp.rint(jnp.exp(u * (logmax - logmin) + logmin))
        rc = jax.random.uniform(k2, (n,)) * (re - ri) + ri
        cs1 = (1.0 / cs0) * rc ** (0.5 * self.temperature_power_law)
        lifetime = 2.0 * jnp.pi * rc * cs1 / m
        u1 = jax.random.uniform(k3, (n,), minval=1e-12)
        u2 = jax.random.uniform(k4, (n,))
        ampl = jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * jnp.pi * u2)
        gs = cfg.grid
        phic = gs.y0 + jax.random.uniform(k5, (n,)) * gs.Ly
        zc = gs.z0 + jax.random.uniform(k6, (n,)) * gs.Lz
        omega = rc ** -1.5
        aspect = jnp.where(
            self.lgravitational_turbulence, 4.0, rc * omega * cs1)
        inv_sigma = aspect * m / (jnp.pi * rc)
        if self.lcap_modes_at_m6:
            ampl = jnp.where(m <= 6, ampl, 0.0)
        return {
            "ampl": ampl, "rc": rc, "phic": phic, "zc": zc,
            "inv_sigma": inv_sigma,
            "t0": jnp.full((n,), t, ampl.dtype),
            "lifetime": lifetime, "omega": omega, "m": m,
        }

    def init_module_state(self, grid, cfg, key, dtype):
        t0 = cfg.time.tstart
        modes = self._draw_modes(key, t0, cfg, self._eos(cfg))
        return {k: v.astype(dtype) for k, v in modes.items()}

    def _eos(self, cfg):
        for m in cfg.modules:
            if m.name == "eos":
                return m
        return None

    def _potential(self, modes, grid, cfg, eos, t):
        gs = cfg.grid
        rad = grid.xg                       # (nx,1,1)
        if gs.coords == "spherical":
            phi = grid.zg                   # (1,1,nz)
            zed = rad * jnp.cos(grid.yg)    # (nx,ny,1)
        else:                               # cylindrical
            phi = grid.yg                   # (1,ny,1)
            zed = grid.zg                   # (1,1,nz)
        cs0 = getattr(eos, "cs0", 1.0)
        amplitude = 8.5e-2 * cs0 * math.sqrt(self.alpha)
        omega2 = self.gsum / rad ** 3
        ampl_scaled = rad ** 2 * omega2 * amplitude
        age = t - modes["t0"]

        def one(ampl, rc, phic, zc, inv_sigma, t0, lifetime, omega, m):
            tda = jnp.where(
                self.ltime_dependant_amplitude,
                jnp.sin(jnp.pi * (t - t0) / lifetime), 1.0)
            return (ampl
                    * jnp.exp(-((rad - rc) * inv_sigma) ** 2)
                    * jnp.cos(m * phi - phic - omega * (t - t0))
                    * (zed - zc) * tda)

        lam = jax.vmap(one)(modes["ampl"], modes["rc"], modes["phic"],
                            modes["zc"], modes["inv_sigma"], modes["t0"],
                            modes["lifetime"], modes["omega"], modes["m"])
        return ampl_scaled * jnp.sum(lam, axis=0)

    def step_module_state(self, modes, fields, grid, cfg, reg, eos, dt, t,
                          key, it=None):
        """Replace expired modes, rebuild Φ (update_modes +
        special_before_boundary, turbpotential.f90:332-458,242-330)."""
        fresh = self._draw_modes(key, t, cfg, eos)
        expired = (t - modes["t0"]) > modes["lifetime"]
        modes = {k: jnp.where(expired, fresh[k].astype(v.dtype), v)
                 for k, v in modes.items()}
        if self.lcalc_potturb:
            pot = self._potential(modes, grid, cfg, eos, t)
            fields = dict(fields)
            fields["potturb"] = jnp.broadcast_to(
                pot, (cfg.grid.nx, cfg.grid.ny, cfg.grid.nz)
            ).astype(modes["ampl"].dtype)
        return modes, fields

    def rhs(self, pen, df, ts):
        if not self.lturbulent_force or "uu" not in pen.reg.slots:
            return
        accumulate(df, "uu", -pen.grad("potturb"))


# diagnostics (print.in names, turbpotential.f90 idiag_*)
from ...io.diagnostics import DIAG_REGISTRY, _vmean  # noqa: E402


def _reg_diags():
    def potturbm(pen, st):
        return _vmean(pen, pen.field("potturb"))

    def potturbmax(pen, st):
        return jnp.max(pen.field("potturb"))

    def potturbmin(pen, st):
        return jnp.min(pen.field("potturb"))

    DIAG_REGISTRY.setdefault("potturbm", potturbm)
    DIAG_REGISTRY.setdefault("potturbmax", potturbmax)
    DIAG_REGISTRY.setdefault("potturbmin", potturbmin)
    for j, c in enumerate("xyz"):
        def g2m(pen, st, j=j):
            return _vmean(pen, pen.grad("potturb")[j] ** 2)
        DIAG_REGISTRY.setdefault(f"gpotturb{c}2m", g2m)


_reg_diags()
