"""Gravitational-wave solver (reference
``src/special/gravitational_waves_hTXk.f90``, Roper Pol et al. 2020):
evolve the two strain polarisations h_T/h_X and their time derivatives
g_T/g_X PER FOURIER MODE, driven by the transverse-traceless projection
of the turbulent stress

    T_ij = (4/3)ρ u_i u_j − B_i B_j − (1/3)δ_ij[(4/3)ρu² − B²]

(calc_pencils_special :766, defaults ctrace_factor='1/3',
fourthird_in_stress='4/3').  Each full timestep the stress (assembled
during substep 1 from the START-of-step state, scaled by
stress_prefactor/scale_factor with scale_factor=(t+tshift)^n) is Fourier
transformed, projected with S_ij=(P_ip P_jq − ½P_ij P_pq)T_pq onto the
polarisation basis e_T=e1e1−e2e2, e_X=e1e2+e2e1, and the harmonic
oscillator ḧ = −k²h + S is advanced EXACTLY over dt
(compute_gT_and_gX_from_gij :1536):

    h(t+dt) = (h − S/ω²)cos ωdt + (g/ω)sin ωdt + S/ω²
    g(t+dt) = −ω(h − S/ω²)sin ωdt + g cos ωdt,  ω = |k|.

The k=0 mode is pinned to zero.  JAX-native: one batched fftn + einsum
projection + elementwise exact rotation for ALL modes at once (the
reference loops mode-by-mode per rank).

Energy diagnostics (dspecial_dt :1002): EEGW = Σ_k(|g_T|²+|g_X|²)·EGWpref
with EGWpref=1/6 for the default cstress_prefactor='6';
hrms = √Σ_k(|h_T|²+|h_X|²).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import jax.numpy as jnp
import numpy as np

from ..base import ModuleBase

_D6 = np.array([-1., 9., -45., 0., 45., -9., 1.]) / 60.0


def _der(f, axis, dx1):
    """6th-order periodic first derivative via rolls (equals the interior
    FD stencil with periodic wrap)."""
    out = 0.0
    for o, c in zip(range(-3, 4), _D6):
        if c != 0.0:
            out = out + c * jnp.roll(f, -o, axis=axis)
    return out * dx1


@dataclass(frozen=True)
class GravitationalWavesHTXk(ModuleBase):
    name: ClassVar[str] = "gravitational_waves"

    stress_prefactor: float = 6.0
    EGWpref: float = 1.0 / 6.0
    trace_factor: float = 1.0 / 3.0
    fourthird_factor: float = 4.0 / 3.0
    nscale_factor_conformal: float = 1.0
    tshift: float = 0.0
    lreynolds: bool = True
    lmagnetic_stress: bool = True

    def register(self, reg):
        reg.register("gw", 8, "aux",
                     comps=("hhT", "hhTim", "hhX", "hhXim",
                            "ggT", "ggTim", "ggX", "ggXim"))
        reg.register("gwstress", 6, "aux")

    # ---- spectral machinery (static, numpy) ----------------------------
    def _basis(self, spec):
        ks = []
        for n, L in ((spec.nx, spec.Lx), (spec.ny, spec.Ly),
                     (spec.nz, spec.Lz)):
            ks.append(np.fft.fftfreq(n) * n * (2 * np.pi / L))
        k1 = ks[0][:, None, None] + 0.0 * ks[1][None, :, None] \
            + 0.0 * ks[2][None, None, :]
        k2 = 0.0 * k1 + ks[1][None, :, None]
        k3 = 0.0 * k1 + ks[2][None, None, :]
        ksqr = k1 ** 2 + k2 ** 2 + k3 ** 2
        # preferred-direction e1/e2 (reference :1973-1990)
        a1, a2, a3 = np.abs(k1), np.abs(k2), np.abs(k3)
        zer = np.zeros_like(k1)
        c_k1 = (a1 < a2) & (a1 < a3)
        c_k2 = (a1 >= a2) & (a2 < a3)
        # else: k3 preferred
        e1 = np.where(c_k1, np.stack([zer, -k3, k2]),
                      np.where(c_k2, np.stack([-k3, zer, k1]),
                               np.stack([k2, -k1, zer])))
        e2 = np.where(c_k1,
                      np.stack([k2 ** 2 + k3 ** 2, -k2 * k1, -k3 * k1]),
                      np.where(c_k2,
                               np.stack([k1 * k2, -(k1 ** 2 + k3 ** 2),
                                         k3 * k2]),
                               np.stack([k1 * k3, k2 * k3,
                                         -(k1 ** 2 + k2 ** 2)])))
        with np.errstate(invalid="ignore", divide="ignore"):
            e1 = np.nan_to_num(e1 / np.sqrt((e1 ** 2).sum(0)))
            e2 = np.nan_to_num(e2 / np.sqrt((e2 ** 2).sum(0)))
            khat = np.nan_to_num(
                np.stack([k1, k2, k3]) / np.sqrt(ksqr))
        P = np.eye(3)[:, :, None, None, None] \
            - khat[:, None] * khat[None, :]
        eT = e1[:, None] * e1[None, :] - e2[:, None] * e2[None, :]
        eX = e1[:, None] * e2[None, :] + e2[:, None] * e1[None, :]
        return ksqr, P, eT, eX

    # ---- hooks ----------------------------------------------------------
    def before_timestep(self, fields, grid, cfg, reg, eos, dt, t, key,
                        it=None):
        """Assemble the (real-space) stress from the START-of-step state
        (reference dspecial_dt runs in substep 1) scaled by
        stress_prefactor/scale_factor."""
        spec = cfg.grid
        uu = fields["uu"]
        rho = jnp.exp(fields["lnrho"]) if "lnrho" in fields \
            else fields["rho"]
        sf = jnp.where(t + self.tshift == 0.0, 1.0,
                       (t + self.tshift) ** self.nscale_factor_conformal)
        pref = self.stress_prefactor / sf
        comps = []
        pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (2, 0))
        if self.lmagnetic_stress and "aa" in fields:
            aa = fields["aa"]
            dx1 = (spec.nx / spec.Lx, spec.ny / spec.Ly, spec.nz / spec.Lz)
            bb = jnp.stack([
                _der(aa[2], 1, dx1[1]) - _der(aa[1], 2, dx1[2]),
                _der(aa[0], 2, dx1[2]) - _der(aa[2], 0, dx1[0]),
                _der(aa[1], 0, dx1[0]) - _der(aa[0], 1, dx1[1]),
            ])
            b2 = jnp.sum(bb * bb, axis=0)
        else:
            bb = None
        u2 = jnp.sum(uu * uu, axis=0)
        for (i, j) in pairs:
            s = 0.0
            if self.lreynolds:
                s = s + self.fourthird_factor * rho * uu[i] * uu[j]
            if bb is not None:
                s = s - bb[i] * bb[j]
            if i == j:
                if self.lreynolds:
                    s = s - self.trace_factor * u2 \
                        * self.fourthird_factor * rho
                if bb is not None:
                    s = s + self.trace_factor * b2
            comps.append(s)
        return {**fields, "gwstress": pref * jnp.stack(comps)}

    def after_timestep(self, fields, grid, cfg, reg, eos, dt, t1, key,
                       it=None):
        """Fourier update of h/g over dt (compute_gT_and_gX_from_gij)."""
        spec = cfg.grid
        ksqr_np, P_np, eT_np, eX_np = self._basis(spec)
        nw = spec.nx * spec.ny * spec.nz
        T6 = fields["gwstress"]
        Tk6 = jnp.fft.fftn(T6, axes=(-3, -2, -1)) / nw
        # full (3,3) tensor from the 6-component storage
        idx = np.array([[0, 3, 5], [3, 1, 4], [5, 4, 2]])
        Tk = Tk6[idx]                              # (3, 3, nx, ny, nz)
        P = jnp.asarray(P_np, Tk.real.dtype)
        # S_ij = P_ia P_jb T_ab − ½ P_ij (P_ab T_ab)
        PT = jnp.einsum("ia...,ab...->ib...", P, Tk)
        S = jnp.einsum("ib...,jb...->ij...", PT, P) \
            - 0.5 * P * jnp.einsum("ab...,ab...->...", P, Tk)[None, None]
        ST = 0.5 * jnp.einsum("ij...,ij...->...",
                              jnp.asarray(eT_np, P.dtype), S)
        SX = 0.5 * jnp.einsum("ij...,ij...->...",
                              jnp.asarray(eX_np, P.dtype), S)

        gw = fields["gw"]
        hT = gw[0] + 1j * gw[1]
        hX = gw[2] + 1j * gw[3]
        gT = gw[4] + 1j * gw[5]
        gX = gw[6] + 1j * gw[7]

        ksqr = jnp.asarray(ksqr_np, gw.dtype)
        om = jnp.sqrt(ksqr)
        om_safe = jnp.maximum(om, 1e-30)
        om12 = 1.0 / jnp.maximum(ksqr, 1e-30)
        cosot = jnp.cos(om * dt)
        sinot = jnp.sin(om * dt)

        def advance(h, g, Sk):
            A = h - om12 * Sk
            B = g / om_safe
            h_new = A * cosot + B * sinot + om12 * Sk
            g_new = B * cosot * om_safe - A * om_safe * sinot
            live = ksqr > 0
            return jnp.where(live, h_new, 0.0), jnp.where(live, g_new, 0.0)

        hT, gT = advance(hT, gT, ST)
        hX, gX = advance(hX, gX, SX)
        gw = jnp.stack([hT.real, hT.imag, hX.real, hX.imag,
                        gT.real, gT.imag, gX.real, gX.imag]).astype(
                            gw.dtype)
        return {**fields, "gw": gw}

    def init_fields(self, grid, spec, eos, key, cfg=None):
        shape = (spec.nx, spec.ny, spec.nz)
        return {"gw": jnp.zeros((8,) + shape),
                "gwstress": jnp.zeros((6,) + shape)}


def make_gravitational_waves(params):
    return GravitationalWavesHTXk(**params)


def gw_spectra(gw, spec):
    """GW spectra (reference make_spectra :1207): shell-integrated
    GWs(k) = Σ_shell |g_T|²+|g_X|² and GWh(k) = Σ_shell |h_T|²+|h_X|²,
    in box-integer shells like power_spectrum.f90."""
    nx, ny, nz = spec.nx, spec.ny, spec.nz
    kx = np.fft.fftfreq(nx) * nx
    ky = np.fft.fftfreq(ny) * ny
    kz = np.fft.fftfreq(nz) * nz
    kmag = np.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                   + kz[None, None, :] ** 2)
    shell = jnp.asarray(np.rint(kmag).astype(np.int32).ravel())
    nk = max(nx, ny, nz) // 2
    import jax
    h2 = (gw[0] ** 2 + gw[1] ** 2 + gw[2] ** 2 + gw[3] ** 2).ravel()
    g2 = (gw[4] ** 2 + gw[5] ** 2 + gw[6] ** 2 + gw[7] ** 2).ravel()
    GWh = jax.ops.segment_sum(h2, shell, num_segments=nk + 1)[:nk]
    GWs = jax.ops.segment_sum(g2, shell, num_segments=nk + 1)[:nk]
    return {"GWs": GWs, "GWh": GWh}
