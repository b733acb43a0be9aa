"""Stochastic helical k-shell forcing (reference ``src/forcing.f90``,
``forcing_hel`` at :1851-2259, applied once per full step OUTSIDE the RK
substeps via ``addforce``, src/run.f90:729).

Each step draws a random wavevector k from the shell |k| ∈ [kf−dk, kf+dk]
(the reference reads the shell from ``k.dat``; we enumerate the same integer
lattice shell at trace time), a random phase φ, and a random transverse
direction, building the helical eigenfunction

    f_k = (k×e − i·σ k̂×(k×e)) / (√(1+σ²) |k×e|)        σ = relhel

so that ∇×f = σ k f for |σ|=1 (maximally helical).  The velocity increment
is Δu = N·Re(f_k e^{i k·x + iφ})·dt with N = force·cs₀·√(kf·cs₀/dt) — the
√dt scaling of δ-correlated forcing."""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax
import jax.numpy as jnp
import numpy as np

from .base import ModuleBase


def shell_vectors(kf: float, dk: float) -> np.ndarray:
    """Integer wavevectors with |k| ∈ [kf−dk, kf+dk] (excluding k=0)."""
    kmax = int(np.ceil(kf + dk))
    rng = np.arange(-kmax, kmax + 1)
    kx, ky, kz = np.meshgrid(rng, rng, rng, indexing="ij")
    kk = np.stack([kx.ravel(), ky.ravel(), kz.ravel()], axis=1).astype(np.float64)
    kabs = np.sqrt((kk ** 2).sum(1))
    sel = (kabs > 0) & (np.abs(kabs - kf) <= dk)
    out = kk[sel]
    if len(out) == 0:
        raise ValueError(f"empty forcing shell kf={kf} dk={dk}")
    return out


@dataclass(frozen=True)
class Forcing(ModuleBase):
    name: ClassVar[str] = "forcing"

    force: float = 0.02
    kf: float = 3.0      # forcing-shell radius in box-wavenumber units
    dk: float = 0.5
    relhel: float = 1.0  # σ: 1 = maximally helical, 0 = non-helical
    # --- parity-replay mode (reference-exact forcing) -------------------
    # sequence: per-step draws ((kx, ky, kz, phase, phi), ...) generated by
    # compat.pencil_rng.forcing_hel_sequence from the reference's nr_f90
    # stream; kav = shell average |k| from k.dat; slope_ff/cs0eff as in
    # fconst_coefs_hel (src/forcing.f90:1554-1730).
    sequence: tuple = None
    kav: float = 0.0
    slope_ff: float = 0.0
    cs0eff: float = 1.0
    # k.dat integer wavevectors are in box units: scale by 2π/L per axis
    # (forcing.f90:1383-1387 lscale_kvector_tobox); kav stays unscaled
    # in ffnorm exactly like the reference
    lscale_kvector_tobox: bool = False
    # --- continuous forcing (forcing.f90 forcing_cont, applied inside the
    # RHS as pencil fcont via hydro's lforcing_cont_uu, hydro.f90:3856) ---
    lforcing_cont: bool = False
    iforcing_cont: str = ""
    ampl_ff: float = 0.0
    k1_ff: float = 1.0
    omega_fcont: float = 0.0
    # box corners (x0, x1, z0, z1) for envelope-profile forcings ('xz')
    fcont_box: tuple = (0.0, 1.0, 0.0, 1.0)

    def fcont(self, grid, t=0.0):
        """The continuous-forcing profile (3, nx, ny, nz) on interior
        coordinates (forcing.f90:930-1100 trig tables + per-case bodies)."""
        k = self.k1_ff
        x, y, z = grid.xg, grid.yg, grid.zg
        prof = self.iforcing_cont
        if prof in ("", "nothing"):
            # reference initialize_forcing: iforcing_cont='nothing' →
            # n_forcing_cont=0, lforcing_cont is inert (forcing.f90:918)
            return jnp.zeros((3,) + tuple(jnp.broadcast_shapes(
                x.shape, y.shape, z.shape)), x.dtype)
        if prof == "xz":
            # F_y = A·(x−x0)(x1−x)·(z−z0)(z1−z) — parabolic poloidal
            # envelope (experimental/forcing_cont_sample.f90:455-458,
            # :3779: the tokamak sample's azimuthal drive)
            gs = self.fcont_box
            zero = jnp.zeros_like(x + y + z)
            fy = (self.ampl_ff * (x - gs[0]) * (gs[1] - x)
                  * (z - gs[2]) * (gs[3] - z)) + zero
            return jnp.stack([zero, fy, zero])
        if prof == "cosx*cosy*cosz":
            # F = −ampl·(sin kx·cos ky·cos kz, cos·sin·cos, cos·cos·sin):
            # the gradient of a potential, ∝ ∇(cos cos cos)/k
            fact = -self.ampl_ff
            return jnp.stack([
                fact * jnp.sin(k * x) * jnp.cos(k * y) * jnp.cos(k * z),
                fact * jnp.cos(k * x) * jnp.sin(k * y) * jnp.cos(k * z),
                fact * jnp.cos(k * x) * jnp.cos(k * y) * jnp.sin(k * z),
            ])
        if prof in ("ABC", "abc"):
            # Arnold-Beltrami-Childress (forcing.f90 case 'ABC')
            a = self.ampl_ff
            zero = jnp.zeros_like(x + y + z)
            return a * jnp.stack([
                jnp.sin(k * z) + jnp.cos(k * y) + zero,
                jnp.sin(k * x) + jnp.cos(k * z) + zero,
                jnp.sin(k * y) + jnp.cos(k * x) + zero,
            ])
        if prof in ("RobertsFlow", "Roberts"):
            # Roberts flow forcing (case 'RobertsFlow'): helical columns
            a = self.ampl_ff
            zero = jnp.zeros_like(x + y + z)
            sqrt2 = 1.4142135623730951
            return a * jnp.stack([
                -jnp.cos(k * x) * jnp.sin(k * y) + zero,
                jnp.sin(k * x) * jnp.cos(k * y) + zero,
                sqrt2 * jnp.cos(k * x) * jnp.cos(k * y) + zero,
            ])
        raise NotImplementedError(
            f"iforcing_cont={prof!r} (implemented: cosx*cosy*cosz, ABC, "
            f"RobertsFlow)")

    def rhs(self, pen, df, ts):
        if not self.lforcing_cont:
            return
        from .base import accumulate
        accumulate(df, "uu", self.fcont(pen.grid))

    def _replay(self, state, grid, cfg, dt, it, t=None):
        """Reference-exact forcing_hel: build the separable helical
        eigenfunction from the recorded (k, phase, φ) draw of step ``it``
        and add fact·Re[(coef1 + i·coef2)·e^{i(k·x+phase)}] to uu
        (src/forcing.f90 fconst_coefs_hel :1578-1730 + the mn-loop
        :1960-2040, default flags: no profiles, qforce=0, omega_ff=0)."""
        dtype = state["uu"].dtype
        tab = jnp.asarray(self.sequence, dtype=jnp.float32)
        row = tab[jnp.clip(it, 0, tab.shape[0] - 1)]
        kvec = row[:3].astype(dtype)
        if self.lscale_kvector_tobox:
            gs0 = cfg.grid
            kvec = kvec * jnp.asarray(
                [2.0 * np.pi / gs0.Lx, 2.0 * np.pi / gs0.Ly,
                 2.0 * np.pi / gs0.Lz], dtype)
        phase = row[3].astype(dtype)
        phi = row[4].astype(dtype)
        kx, ky, kz = kvec[0], kvec[1], kvec[2]
        shear = cfg.module("shear") if cfg is not None else None
        if shear is not None and t is not None:
            # shearing-frame forcing: kx stays shear-periodic while
            # remaining near kx0 (forcing.f90:1396-1407, new branch)
            gs = cfg.grid
            deltay = shear.deltay(t, gs.Lx, gs.Ly)
            pix = jnp.pi / gs.Lx
            arg = ky * deltay / gs.Lx - pix
            # Fortran mod keeps the sign of the dividend
            fmod = arg - jnp.trunc(arg / (2.0 * pix)) * (2.0 * pix)
            kx = kx + fmod + pix
            kvec = jnp.stack([kx, ky, kz])
        # polarization: e = x̂ unless k ∥ x̂ (then ŷ); rotate by φ in the
        # plane ⊥ k (old_forcing_evector=F branch)
        e_is_y = (ky == 0.0) & (kz == 0.0)
        e = jnp.where(e_is_y, jnp.asarray([0.0, 1.0, 0.0], dtype),
                      jnp.asarray([1.0, 0.0, 0.0], dtype))
        e1 = jnp.cross(kvec, e)
        e1 = e1 / jnp.sqrt(jnp.sum(e1 * e1))
        e2 = jnp.cross(kvec, e1)
        e2 = e2 / jnp.sqrt(jnp.sum(e2 * e2))
        ee = jnp.cos(phi) * e1 + jnp.sin(phi) * e2
        k2 = jnp.sum(kvec * kvec)
        k = jnp.sqrt(k2)
        kde = jnp.sum(kvec * ee)
        kxe = jnp.cross(kvec, ee)            # (kex, key, kez)
        kkxe = jnp.cross(kvec, kxe)          # (kkex, kkey, kkez)
        sig = self.relhel
        ffnorm = (jnp.sqrt(1.0 + sig * sig) * k
                  * jnp.sqrt(k2 - kde * kde)
                  / np.sqrt(self.kav * self.cs0eff ** 3)
                  * (k / self.kav) ** self.slope_ff)
        fact = self.force / ffnorm * jnp.sqrt(dt)
        coef1 = k * kxe
        coef2 = sig * kkxe
        theta = (kx * grid.xg + ky * grid.yg + kz * grid.zg + phase)
        c, s = jnp.cos(theta), jnp.sin(theta)
        # Re[(coef1 + i coef2)(cosθ + i sinθ)] = coef1 cosθ − coef2 sinθ
        duu = fact * jnp.stack([
            coef1[0] * c - coef2[0] * s,
            coef1[1] * c - coef2[1] * s,
            coef1[2] * c - coef2[2] * s,
        ])
        state = dict(state)
        state["uu"] = state["uu"] + duu.astype(dtype)
        return state

    def kick_coeffs(self, key, dt, cfg, eos, dtype):
        """Per-step helical-kick coefficients (the random-draw half of
        addforce): returns (k_phys(3), phase, f_re(3), f_im(3), N·dt).
        duu = N·dt·Re[(f_re + i f_im)·e^{i(k·x+phase)}]."""
        kk_table = jnp.asarray(shell_vectors(self.kf, self.dk), dtype=dtype)
        nk = kk_table.shape[0]
        k_idx, k_phase, k_e = jax.random.split(key, 3)
        # draws are 32-bit whatever the state dtype, so a float64 run is
        # forced exactly like the float32 run from the same key
        idx = jax.random.randint(k_idx, (), 0, nk, dtype=jnp.int32)
        kvec = kk_table[idx]                      # (3,) in integer units
        phase = jax.random.uniform(k_phase, (), jnp.float32, minval=-jnp.pi,
                                   maxval=jnp.pi).astype(dtype)
        # random direction for e, redrawn to avoid near-parallel with k
        e = jax.random.normal(k_e, (3,), jnp.float32).astype(dtype)
        e = e / jnp.sqrt(jnp.sum(e * e))
        # Gram-Schmidt: remove component along k
        khat = kvec / jnp.sqrt(jnp.sum(kvec * kvec))
        e = e - jnp.sum(e * khat) * khat
        e = e / jnp.maximum(jnp.sqrt(jnp.sum(e * e)), 1e-12)

        kxe = jnp.cross(kvec, e)
        kxe = kxe / jnp.maximum(jnp.sqrt(jnp.sum(kxe * kxe)), 1e-12)
        kxkxe = jnp.cross(khat, kxe)
        sig = self.relhel
        norm = 1.0 / jnp.sqrt(1.0 + sig * sig)
        f_re = norm * kxe                      # real part of f_k
        f_im = -norm * sig * kxkxe             # imag part (−iσ k̂×(k×e))

        # physical wavevector: integer k scaled by 2π/L per axis
        gs = cfg.grid
        k_phys = kvec * jnp.asarray(
            [2.0 * np.pi / gs.Lx, 2.0 * np.pi / gs.Ly, 2.0 * np.pi / gs.Lz],
            dtype=kvec.dtype)
        cs0 = eos.cs0 if eos is not None else 1.0
        kf_mag = jnp.sqrt(jnp.sum(k_phys * k_phys))
        N = self.force * cs0 * jnp.sqrt(kf_mag * cs0 / jnp.maximum(dt, 1e-30))
        return k_phys, phase, f_re, f_im, N * dt

    def after_timestep(self, state, grid, cfg, reg, eos, dt, t, key,
                       it=None):
        """Replay mode: kick ``it`` (0-based step just completed) with this
        step's dt — our post-step state then equals the reference's
        time-series row it+1 exactly (addforce runs after prints,
        src/run.f90:696-729, so each golden row is a post-kick state; only
        the dt *column* lags one step, being the NEXT iteration's CFL)."""
        if self.sequence is not None:
            return self._replay(state, grid, cfg, dt, it, t=t)
        if self.force == 0.0:
            return state     # iforce='zero': continuous-only forcing
        k_phys, phase, f_re, f_im, Ndt = self.kick_coeffs(
            key, dt, cfg, eos, state["uu"].dtype)
        theta = (k_phys[0] * grid.xg + k_phys[1] * grid.yg
                 + k_phys[2] * grid.zg + phase)
        c, s = jnp.cos(theta), jnp.sin(theta)
        duu = Ndt * jnp.stack([
            f_re[0] * c - f_im[0] * s,
            f_re[1] * c - f_im[1] * s,
            f_re[2] * c - f_im[2] * s,
        ])
        state = dict(state)
        state["uu"] = state["uu"] + duu
        return state
