"""CHEMKIN-driven multispecies chemistry (reference ``src/chemistry.f90``
with ``lcheminp``: get_reaction_rate :4150-4386, calc_reaction_term
:4494-4610, thermochemistry pencils :842-930, heat release into the lnTT
equation :3040-3125; EOS closures from ``src/eos_chemistry.f90``).

The mechanism (species, NASA-7 thermo, stoichiometry, Arrhenius, third
bodies, Lindemann/Troe falloff) is parsed by ``compat/chemkin.py`` into
numpy arrays; this module evaluates the whole reaction network as a few
batched einsum/where expressions over the grid — one fused XLA kernel
instead of the reference's per-reaction pencil loop.

Units: the chem.inp convention is cm³·mol·s·cal·K (chemistry.f90:4-8);
the reference's quirky Rcal = Rgas/4.14e7 (NOT 4.184; chemistry.f90:4194)
is reproduced for parity.
"""
from __future__ import annotations

import math

from dataclasses import dataclass, field as dfield
from typing import ClassVar, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import ModuleBase, accumulate

# k_B/m_u in cgs (reference cparam.f90:184-185)
RGAS = 1.3806505e-16 / 1.66053886e-24     # erg/(mol K)
RCAL1 = 1.0 / (RGAS / 4.14 * 1e-7)        # 1/Rcal (chemistry.f90:4194)
LN_P_ATM = float(np.log(1e6))             # ln(1 bar in dyn/cm²), cgs units


def _nasa_eval(nasa, T_mid, TT, lnTT, kind):
    """Evaluate NASA-7 per species: cp/R, H0/RT or S0/R.
    nasa: (ns,2,7) [low, high]; returns (ns, ...) broadcast over TT."""
    TT = TT[None]
    lnTT = lnTT[None]
    lo, hi = nasa[:, 0], nasa[:, 1]
    use_lo = TT <= T_mid[:, None, None, None]

    def poly(a):
        a = [c[:, None, None, None] for c in a.T]
        T2, T3, T4 = TT * TT, TT ** 3, TT ** 4
        if kind == "cp":
            return a[0] + a[1] * TT + a[2] * T2 + a[3] * T3 + a[4] * T4
        if kind == "h":
            return (a[0] + a[1] * TT / 2 + a[2] * T2 / 3 + a[3] * T3 / 4
                    + a[4] * T4 / 5 + a[5] / TT)
        return (a[0] * lnTT + a[1] * TT + a[2] * T2 / 2 + a[3] * T3 / 3
                + a[4] * T4 / 4 + a[6])

    return jnp.where(use_lo, poly(lo), poly(hi))


@dataclass(frozen=True, eq=False)
class ChemistryChemkin(ModuleBase):
    name: ClassVar[str] = "chemistry"

    mech: object = None            # compat.chemkin.Mechanism
    init: str = "air"
    T_init: float = 300.0
    P_init: float = 1.013e6        # dyn/cm²
    Y_init: Tuple[Tuple[str, float], ...] = ()
    lreactions: bool = True
    # LSODE-analog operator splitting (reference
    # src/lsode_for_chemistry.f90 via split_update, timestep.f90:199):
    # reaction source terms leave the explicit RHS and are integrated
    # per cell over the full dt by sub-stepped backward-Euler/Newton —
    # L-stable, so stiff networks no longer collapse the CFL dt
    lsplit_reactions: bool = False
    nsplit_substeps: int = 8
    newton_iters: int = 4
    ladvection: bool = True
    ldiffusion: bool = False
    lheatc_chemistry: bool = False
    lDiff_simple: bool = False
    lThCond_simple: bool = False
    Diff_coef_const: float = 2.58e-4    # rho0*D0 (chemistry.f90:1015)
    lambda_const: float = 2.58e-4       # lambda0/cp0 (chemistry.f90:969)
    lfilter: bool = False
    tran: object = None                 # (ns,6) tran.dat table or None
    # flame_front initial condition (chemistry.f90 flame_front)
    init_TT1: float = 298.0
    init_TT2: float = 2400.0
    init_x1: float = -0.2
    init_x2: float = 0.2
    init_ux: float = 0.0
    init_pressure: float = 1.013e6
    # FlameMaster initial condition (chemistry.f90:5982 FlameMaster_ini):
    # path to the solution file + target flame position (cc=0.7 point)
    init_file: str = ""
    flame_pos: float = 0.0

    def register(self, reg):
        reg.register("chem", self.mech.ns, "pde",
                     comps=tuple(self.mech.species))

    # ---- mixture thermo helpers ---------------------------------------
    def mixture(self, Y, TT, lnTT):
        m = self.mech
        W1 = (1.0 / m.mass)[:, None, None, None]
        mu1 = jnp.sum(Y * W1, axis=0)                      # Σ Y_k/W_k
        cpR = _nasa_eval(m.nasa, m.T_ranges[:, 1], TT, lnTT, "cp")
        cv = jnp.sum(Y * (cpR - 1.0) * RGAS * W1, axis=0)  # erg/(g K)
        cp = jnp.sum(Y * cpR * RGAS * W1, axis=0)
        return mu1, cp, cv

    def _reaction_term(self, pen, Y, TT, lnTT, rho, TT1, mu1, H0RT):
        m = self.mech
        W = m.mass[:, None, None, None]
        conc = Y * rho[None] / W                # mol/cm³

        # ln kf = ln A + b lnT − E/(Rcal T)   (chemistry.f90:4253)
        lnkf = (m.lnA[:, None, None, None]
                + m.b[:, None, None, None] * lnTT[None]
                - (m.E_cal * RCAL1)[:, None, None, None] * TT1[None])

        # equilibrium: ln Kc = ΔS/R − ΔH/RT + Δν(ln p_atm − lnT − lnR)
        S0R = _nasa_eval(m.nasa, m.T_ranges[:, 1], TT, lnTT, "s")
        H0RT = _nasa_eval(m.nasa, m.T_ranges[:, 1], TT, lnTT, "h")
        dnu = m.Sijm - m.Sijp                   # (ns, nr)
        dSR = jnp.einsum("kj,k...->j...", dnu, S0R)
        dHRT = jnp.einsum("kj,k...->j...", dnu, H0RT)
        sum_nu = dnu.sum(axis=0)[:, None, None, None]
        lnKc = dSR - dHRT + sum_nu * (LN_P_ATM - lnTT[None]
                                      - float(np.log(RGAS)))

        # concentration products over reactant/product stoichiometry
        def cprod(S):
            p = jnp.where(S[:, :, None, None, None] > 0,
                          conc[:, None] ** S[:, :, None, None, None], 1.0)
            return jnp.prod(p, axis=0)          # (nr, ...)
        prod1 = cprod(m.Sijp)
        prod2 = cprod(m.Sijm)

        # third bodies: Σ a_k4·c_k where efficiencies exist, else total
        # molar concentration (used only by falloff)   chemistry.f90:4276
        eff = np.nan_to_num(m.a_k4, nan=0.0)
        has_eff = ~np.isnan(m.a_k4).all(axis=0)
        sum_sp_tb = jnp.einsum("kj,k...->j...", eff, conc)
        total_c = (rho * mu1)[None]
        mix_conc = jnp.where(has_eff[:, None, None, None],
                             sum_sp_tb, total_c)
        sum_sp = jnp.where(has_eff[:, None, None, None], sum_sp_tb, 1.0)

        # Lindemann falloff + Troe broadening      chemistry.f90:4288-4320
        if m.has_low.any():
            lnkf0 = (m.low[:, 0, None, None, None]
                     + m.low[:, 1, None, None, None] * lnTT[None]
                     - (m.low[:, 2] * RCAL1)[:, None, None, None]
                     * TT1[None])
            # work in log space: ln k0/k∞ reaches ~170 at T=300 for CH4
            # falloff reactions and exp() overflows f32 → Pr=inf → NaN;
            # ln(Pr/(1+Pr)) = log_sigmoid(ln Pr) is overflow-safe
            lnPr = (lnkf0 - lnkf
                    + jnp.log(jnp.maximum(mix_conc, 1e-300)))
            lnkf_fall = lnkf + jax.nn.log_sigmoid(lnPr)
            lnkf = jnp.where(m.has_low[:, None, None, None],
                             lnkf_fall, lnkf)
            if m.has_troe.any():
                a = m.troe[:, 0, None, None, None]
                T3 = m.troe[:, 1, None, None, None]
                T1 = m.troe[:, 2, None, None, None]
                Fcent = ((1.0 - a) * jnp.exp(-TT[None] / T3)
                         + a * jnp.exp(-TT[None] / T1))
                l10Fc = jnp.log10(jnp.maximum(Fcent, 1e-300))
                ccc = -0.4 - 0.67 * l10Fc
                nnn = 0.75 - 1.27 * l10Fc
                l10Pr = lnPr / float(np.log(10.0))
                tmpF = ((l10Pr + ccc) / (nnn - 0.14 * (l10Pr + ccc))) ** 2
                FF = l10Fc / (1.0 + tmpF) * float(np.log(10.0))
                lnkf = jnp.where(m.has_troe[:, None, None, None],
                                 lnkf + FF, lnkf)

        lnkr = lnkf - lnKc
        # ('(+M)' falloff reactions are NOT multiplied by Σa·c, plain +M
        # third-body reactions are — chemistry.f90:4330-4350)
        fac = jnp.where(m.mplus[:, None, None, None], 1.0, sum_sp)
        vp = jnp.where(prod1 > 0, prod1 * jnp.exp(lnkf), 0.0) * fac
        vm = jnp.where(prod2 > 0, prod2 * jnp.exp(lnkr), 0.0) * fac
        vm = jnp.where(m.back[:, None, None, None], vm, 0.0)
        v = vp - vm                              # mol/cm³/s, (nr, ...)

        # ω̇_k → DYDt (chemistry.f90:4563; stoichio = Sijp − Sijm)
        stoichio = m.Sijp - m.Sijm
        return -jnp.einsum("kj,j...->k...", stoichio, v) * (W / rho[None])

    # ---- ghosted-field calculus (non-registered scalars) ---------------
    @staticmethod
    def _dg(pen, gh, axis):
        from ..ops import stencil as st
        from ..ops.stencil import i as interior
        rest = tuple(a for a in range(3) if a != axis)
        out = st.der(gh[None], axis, None, g=pen._g)
        return interior(out, rest, g=pen._g)[0] * pen._inv(axis)

    @classmethod
    def _gradg(cls, pen, gh):
        return jnp.stack([cls._dg(pen, gh, a) for a in range(3)])

    @staticmethod
    def _del2g(pen, gh):
        from ..ops import stencil as st
        from ..ops.stencil import i as interior
        tot = 0.0
        for axis in range(3):
            rest = tuple(a for a in range(3) if a != axis)
            out = st.der2(gh[None], axis, None, g=pen._g)
            tot = tot + interior(out, rest,
                                 g=pen._g)[0] * pen._inv(axis) ** 2
        return tot

    def species_viscosity_gh(self, Tgh, lnTgh):
        """Per-species dynamic viscosity from the tran.dat LJ parameters
        (chemistry.f90 calc_diff_visc_coef :4754-4805, Omega22 collision
        integral :4648)."""
        m = self.mech
        t = np.asarray(self.tran)
        KB = 1.3806505e-16
        NA = 6.022e23
        aa = (6.33225679e-1, 3.14473541e-1, 1.78229325e-2, -3.99489493e-2,
              8.98483088e-3, 7.00167217e-4, -3.82733808e-4, 2.97208112e-5)
        tmp_local = 5.0 / 16.0 * np.sqrt(KB / (NA * np.pi))
        etas = []
        for k in range(m.ns):
            eps, sig, dip = t[k, 1], t[k, 2] * 1e-8, t[k, 3] * 1e-18
            c_k = np.sqrt(m.mass[k]) / sig ** 2 * tmp_local
            delta_st = dip * dip / 2.0 / (eps * KB * sig ** 3)
            lnTst = lnTgh - np.log(eps)
            om = 0.0
            for i, a in enumerate(aa):
                om = om + a * lnTst ** i
            om22 = 1.0 / om
            etas.append(jnp.sqrt(Tgh) / (om22 + 0.2 * delta_st ** 2
                                         / (Tgh / eps)) * c_k)
        return jnp.stack(etas)

    def mixture_nu_gh(self, pen):
        """Wilke mixture kinematic viscosity on the ghosted grid
        (chemistry.f90:2496-2524) — cached per pencil set."""
        if "nu_mixture_gh" in pen._cache:
            return pen._cache["nu_mixture_gh"]
        m = self.mech
        Ygh = pen._gh("chem")
        lnTgh = pen._gh("lnTT")[0]
        Tgh = jnp.exp(lnTgh)
        rgh = jnp.exp(pen._gh("lnrho")[0])
        W1 = (1.0 / m.mass)[:, None, None, None]
        mu1gh = jnp.sum(Ygh * W1, axis=0)
        XXgh = Ygh * W1 / mu1gh[None]
        eta = self.species_viscosity_gh(Tgh, lnTgh)
        mu_dyn = 0.0
        for k in range(m.ns):
            denom = 0.0
            for j in range(m.ns):
                mk_mj = m.mass[k] / m.mass[j]
                phi = (1.0 / np.sqrt(8.0) / np.sqrt(1.0 + mk_mj)
                       * (1.0 + jnp.sqrt(eta[k] / eta[j])
                          * mk_mj ** -0.25) ** 2)
                denom = denom + XXgh[j] * phi
            mu_dyn = mu_dyn + XXgh[k] * eta[k] / denom
        nugh = mu_dyn / rgh
        pen._cache["nu_mixture_gh"] = nugh
        return nugh

    def rhs(self, pen, df, ts):
        m = self.mech
        Y = pen.field("chem")                   # (ns, nx, ny, nz)
        TT = pen.TT()
        lnTT = pen.lnTT()
        rho = pen.rho()
        rho1 = pen.rho1()
        TT1 = 1.0 / TT
        W = m.mass[:, None, None, None]
        mu1, cp, cv = self.mixture(Y, TT, lnTT)
        pen._cache["cv_mix"] = cv
        pen._cache["cp_mix"] = cp
        pen._cache["mu1_mix"] = mu1
        H0RT = _nasa_eval(m.nasa, m.T_ranges[:, 1], TT, lnTT, "h")
        cpR = _nasa_eval(m.nasa, m.T_ranges[:, 1], TT, lnTT, "cp")
        zero = jnp.zeros_like(Y)

        lreac_expl = self.lreactions and not self.lsplit_reactions
        DYDt_reac = self._reaction_term(pen, Y, TT, lnTT, rho, TT1, mu1,
                                        H0RT) if lreac_expl else zero

        # ---- species diffusion (lDiff_simple coefficients, detailed flux
        # form: chemistry.f90:5014-5066) --------------------------------
        DYDt_diff = zero
        sum_dk_ghk = 0.0
        if self.ldiffusion and self.lDiff_simple:
            Ygh = pen._gh("chem")
            lnTgh = pen._gh("lnTT")[0]
            Tgh = jnp.exp(lnTgh)
            lnrgh = pen._gh("lnrho")[0]
            rgh = jnp.exp(lnrgh)
            W1g = (1.0 / m.mass)[:, None, None, None]
            mu1gh = jnp.sum(Ygh * W1g, axis=0)
            XXgh = Ygh * W1g / mu1gh[None]
            ppgh = rgh * RGAS * mu1gh * Tgh
            glnTT = pen.glnTT()
            glnrho = pen.glnrho()
            gTT = TT[None] * glnTT
            D = self.Diff_coef_const * rho1 * jnp.exp(
                0.7 * jnp.log(TT / 298.0))
            gD = D[None] * (0.7 * glnTT - glnrho)       # (3, ...)
            gmu1 = self._gradg(pen, mu1gh)
            glnmu = -gmu1 / mu1[None]                   # ∇ln(mu)
            glnpp = glnrho + glnTT - glnmu
            pp = rho * RGAS * mu1 * TT
            del2lnpp = self._del2g(pen, ppgh) / pp                 - jnp.sum(glnpp * glnpp, axis=0)
            glnrho_glnpp = jnp.sum(glnrho * glnpp, axis=0)
            gD_glnpp = jnp.sum(gD * glnpp, axis=0)
            glnmu_glnpp = jnp.sum(glnmu * glnpp, axis=0)
            diffs = []
            for k in range(m.ns):
                mukmu1 = m.mass[k] * mu1
                del2XX = self._del2g(pen, XXgh[k])
                gXX = self._gradg(pen, XXgh[k])
                gYY = jnp.stack([pen.d("chem", a)[k] for a in range(3)])
                Xk_Yk = Y[k] / (m.mass[k] * mu1) - Y[k]  # X_k - Y_k
                gXk_Yk = gXX - gYY
                diff_op1 = jnp.sum(glnrho * gXX, axis=0)
                diff_op2 = jnp.sum(gD * gXX, axis=0)
                diff_op3 = jnp.sum(glnmu * gXX, axis=0)
                glnpp_gXkYk = jnp.sum(glnpp * gXk_Yk, axis=0)
                dk = (D * mukmu1 * (del2XX + diff_op1 - diff_op3)
                      + mukmu1 * diff_op2
                      + D * mukmu1 * Xk_Yk
                      * (del2lnpp + glnrho_glnpp - glnmu_glnpp)
                      + Xk_Yk * mukmu1 * gD_glnpp
                      + D * mukmu1 * glnpp_gXkYk)
                diffs.append(dk)
                # enthalpy flux dk_D·∇h_k (chemistry.f90:3060-3082);
                # ∇h_k = (R/W_k)·cp_k/R·∇T
                dk_D = D[None] * mukmu1[None] * (gXX
                                                 + Xk_Yk[None] * glnpp)
                ghhk = (RGAS / m.mass[k]) * cpR[k][None] * gTT
                sum_dk_ghk = sum_dk_ghk + jnp.sum(dk_D * ghhk, axis=0)
            DYDt_diff = jnp.stack(diffs)
            ts.diffus(jnp.max(D))

        out = DYDt_reac + DYDt_diff
        pen._cache["RHS_Y"] = out
        if self.ladvection and "uu" in pen.reg.slots:
            uu = pen.uu()
            out = out - sum(uu[a][None] * pen.d("chem", a)
                            for a in range(3))

        # negative/overshoot filter (chemistry.f90:3013-3021; acts on df
        # with the CURRENT dt — only exact for fixed-dt runs, which is the
        # only place the reference samples enable it)
        if self.lfilter and pen.cfg is not None and pen.cfg.time.dt > 0:
            dtf = pen.cfg.time.dt
            out = jnp.where(Y + out * dtf < -1e-25, -1e-25 * dtf, out)
            out = jnp.where(Y + out * dtf > 1.0, 1.0 * dtf, out)
        accumulate(df, "chem", out)

        # ---- temperature equation (chemistry.f90:3048-3115) ------------
        hk = H0RT * RGAS * TT[None] / W          # erg/g
        DY_tot = DYDt_reac + DYDt_diff
        sum_DYDt = jnp.sum(RGAS / W * DY_tot, axis=0)
        if lreac_expl:
            sum_hhk = -jnp.sum(hk * DYDt_reac, axis=0)
        else:
            sum_hhk = 0.0
        if "uu" in pen.reg.slots:
            sum_DYDt = sum_DYDt - RGAS * mu1 * pen.divu()
        RHS_T = (sum_DYDt + (sum_hhk + sum_dk_ghk) * TT1) / cv
        if "lnTT" in pen.reg.slots:
            accumulate(df, "lnTT", RHS_T)
        elif "TT" in pen.reg.slots:
            accumulate(df, "TT", RHS_T * TT)

        # ---- heat conduction (calc_heatcond_chemistry :5089-5126) ------
        if self.lheatc_chemistry and self.lThCond_simple                 and "lnTT" in pen.reg.slots:
            Ygh = pen._gh("chem")
            lnTgh = pen._gh("lnTT")[0]
            Tgh = jnp.exp(lnTgh)
            W1g = (1.0 / m.mass)[:, None, None, None]
            cpRgh = _nasa_eval(m.nasa, m.T_ranges[:, 1], Tgh, lnTgh, "cp")
            cpgh = jnp.sum(Ygh * cpRgh * RGAS * W1g, axis=0)
            lamgh = self.lambda_const * cpgh * jnp.exp(
                0.7 * (lnTgh - np.log(298.0)))
            lam = self.lambda_const * cp * jnp.exp(
                0.7 * (lnTT - np.log(298.0)))
            glam = self._gradg(pen, lamgh)
            glnTT = pen.glnTT()
            g2TT = jnp.sum(glnTT * glnTT, axis=0)
            g2TTlam = jnp.sum(glnTT * glam, axis=0)
            tmp = (lam * (pen.del2s("lnTT") + g2TT) + g2TTlam) / cv * rho1
            accumulate(df, "lnTT", tmp)
            ts.diffus(jnp.max(lam / (rho * cp)) * (cp / cv))

    def _point_rhs(self, u, rho_):
        """Per-cell reaction ODE rhs on u = (Y_1..Y_ns, lnTT) at fixed ρ
        (isochoric split, as the reference LSODE call): returns du/dt."""
        m = self.mech
        ns = m.ns
        Yc = u[:ns].reshape(ns, 1, 1, 1)
        ln = u[ns].reshape(1, 1, 1)
        TT = jnp.exp(ln)
        TT1 = 1.0 / TT
        W = m.mass[:, None, None, None]
        W1 = 1.0 / W
        mu1 = jnp.sum(Yc * W1, axis=0)
        H0RT = _nasa_eval(m.nasa, m.T_ranges[:, 1], TT, ln, "h")
        w = self._reaction_term(None, Yc, TT, ln, rho_.reshape(1, 1, 1),
                                TT1, mu1, H0RT)
        cpR = _nasa_eval(m.nasa, m.T_ranges[:, 1], TT, ln, "cp")
        cv = jnp.sum(Yc * (cpR - 1.0) * RGAS * W1, axis=0)
        hk = H0RT * RGAS * TT[None] * W1
        sum_DYDt = jnp.sum(RGAS * W1 * w, axis=0)
        sum_hhk = -jnp.sum(hk * w, axis=0)
        dln = (sum_DYDt + sum_hhk * TT1) / cv
        return jnp.concatenate([w.reshape(ns), dln.reshape(1)])

    def split_update(self, fa, model, grid, dt):
        """Operator-split stiff reaction integration over the full step
        (reference split_update → lsode_for_chemistry): sub-stepped
        backward Euler with a vmapped per-cell Newton solve on the
        (ns+1)-dim (Y, lnTT) system."""
        if not (self.lreactions and self.lsplit_reactions):
            return fa
        reg = model.reg
        m = self.mech
        ns = m.ns
        Y = fa[reg.slice("chem")]
        shape = Y.shape[1:]
        N = int(np.prod(shape))
        if "lnTT" in reg.slots:
            lnT = fa[reg.slice("lnTT")][0]
        else:
            lnT = jnp.log(fa[reg.slice("TT")][0])
        if "lnrho" in reg.slots:
            rho = jnp.exp(fa[reg.slice("lnrho")][0])
        elif "rho" in reg.slots:
            rho = fa[reg.slice("rho")][0]
        else:
            rho = jnp.ones(shape, fa.dtype)
        U0 = jnp.concatenate(
            [Y.reshape(ns, N), lnT.reshape(1, N)], axis=0).T   # (N, ns+1)
        rf = rho.reshape(N)
        h = dt / self.nsplit_substeps
        eye = jnp.eye(ns + 1, dtype=fa.dtype)
        jac = jax.jacfwd(self._point_rhs)

        def be_substep(u0, rho_):
            def newton(u, _):
                F = u - u0 - h * self._point_rhs(u, rho_)
                J = eye - h * jac(u, rho_)
                return u - jnp.linalg.solve(J, F), None
            u, _ = jax.lax.scan(newton, u0, None,
                                length=self.newton_iters)
            return u

        def cell(u0, rho_):
            def body(u, _):
                return be_substep(u, rho_), None
            u, _ = jax.lax.scan(body, u0, None,
                                length=self.nsplit_substeps)
            return u

        out = jax.vmap(cell)(U0, rf)                           # (N, ns+1)
        Yn = jnp.clip(out[:, :ns].T.reshape((ns,) + shape), 0.0, 1.0)
        lnTn = out[:, ns].reshape(shape)
        fa = fa.at[reg.slice("chem")].set(Yn.astype(fa.dtype))
        if "lnTT" in reg.slots:
            fa = fa.at[reg.slice("lnTT")].set(
                lnTn[None].astype(fa.dtype))
        else:
            fa = fa.at[reg.slice("TT")].set(
                jnp.exp(lnTn)[None].astype(fa.dtype))
        return fa

    def init_fields(self, grid, spec, eos, key, cfg=None):
        """Reference air_field (chemistry.f90): mass fractions from the
        composition table, ρ = P·μ/(R T), lnTT = ln T.  Overrides the
        density/temperature module inits (module order puts chemistry
        after them, exactly like the reference's init_chemistry)."""
        m = self.mech
        shape = spec.shape
        Y = np.zeros((m.ns,) + shape)
        for name, frac in self.Y_init:
            if name in m.species:
                Y[m.species.index(name)] = frac
        mu1 = sum(f / m.mass[m.species.index(n)]
                  for n, f in self.Y_init if n in m.species)
        if self.init == "flame_front":
            return self._flame_front(grid, spec, shape, Y)
        if self.init == "FlameMaster":
            return self._flamemaster(grid, spec, shape)
        rho0 = self.P_init / (RGAS * mu1 * self.T_init)
        out: Dict[str, np.ndarray] = {
            "chem": jnp.asarray(Y),
            "lnTT": jnp.full(shape, float(np.log(self.T_init))),
            "lnrho": jnp.full(shape, float(np.log(rho0))),
        }
        return out

    def _flamemaster(self, grid, spec, shape):
        """Initialize from a FlameMaster premixed-flame solution file
        (reference chemistry.f90:5982-6136 FlameMaster_ini): parse the
        body sections (grid [m]→cm, massflowrate/ρ→u [cm/s], temperature,
        density [kg/m³]→[g/cm³], massfraction-*), shift so the progress-
        variable cc=0.7 point sits at flame_pos, linearly interpolate
        onto x, renormalize ΣY=1."""
        m = self.mech
        secs: Dict[str, list] = {}
        cur = None
        with open(self.init_file) as fh:
            in_body = False
            for line in fh:
                t = line.strip()
                if t == "body":
                    in_body = True
                    continue
                if not in_body:
                    continue
                if t == "trailer":
                    break
                parts = t.split()
                if parts and not parts[0][0].isdigit() \
                        and not parts[0][0] in "+-.":
                    cur = parts[0]
                    secs[cur] = []
                elif cur is not None:
                    secs[cur].extend(float(v) for v in parts)
        xs = np.asarray(secs.get("y", []), float) * 100.0       # m → cm
        Tp = np.asarray(secs["temperature"], float)
        rhop = np.asarray(secs["density"], float) / 1000.0      # → g/cm³
        # u = ṁ/ρ with BOTH still SI (chemistry.f90:6041 divides before
        # the ×100 m/s→cm/s and BEFORE the density /1000)
        up = (np.asarray(secs["massflowrate"], float)
              / (rhop * 1000.0) * 100.0)
        cc = (Tp - Tp[0]) / (Tp[-1] - Tp[0])
        imid = int(np.argmax(cc > 0.7))
        ipos = int(np.argmax(xs > self.flame_pos))
        shift = xs[imid] - xs[ipos]
        x = np.asarray(grid.x)[spec.nghost:-spec.nghost]
        xq = x + shift

        def interp(vals):
            return np.interp(xq, xs, vals)

        Tg = interp(Tp)[:, None, None] + np.zeros(shape)
        rg = interp(rhop)[:, None, None] + np.zeros(shape)
        ug = interp(up)[:, None, None] + np.zeros(shape)
        Y = np.zeros((m.ns,) + shape)
        for key, vals in secs.items():
            if key.startswith("massfraction-"):
                sp = key[len("massfraction-"):]
                if sp in m.species:
                    Y[m.species.index(sp)] = \
                        interp(np.asarray(vals, float))[:, None, None]
        Y = Y / np.maximum(Y.sum(axis=0, keepdims=True), 1e-30)
        zero = np.zeros(shape)
        out = {
            "chem": jnp.asarray(Y),
            "lnrho": jnp.asarray(np.log(rg)),
            "uu": jnp.asarray(np.stack([ug, zero, zero])),
        }
        out["lnTT"] = jnp.asarray(np.log(Tg))
        return out

    def _flame_front(self, grid, spec, shape, Y):
        """1-D premixed H2 flame profile (reference chemistry.f90
        flame_front): piecewise-linear T between init_TT1/TT2 over
        [init_x1, init_x2], fuel consumed ∝ (T−T2)/(T1−T2), O2 down to
        the lean-burn limit, H2O produced, ρ from p/(R μ⁻¹T), ux +=
        init_ux, species renormalised to Σ=1."""
        m = self.mech
        x = np.asarray(grid.x)
        g = spec.nghost
        if x.shape[0] > spec.nx:
            x = x[g:-g]
        T1, T2 = self.init_TT1, self.init_TT2
        x1, x2 = self.init_x1, self.init_x2
        TT = np.where(x <= x1, T1,
                      np.where(x >= x2, T2,
                               (x - x1) / (x2 - x1) * (T2 - T1) + T1))
        iH2 = m.species.index("H2")
        iO2 = m.species.index("O2")
        iH2O = m.species.index("H2O")
        iN2 = m.species.index("N2") if "N2" in m.species else None
        init_H2 = float(Y[iH2, 0, 0, 0])
        init_O2 = float(Y[iO2, 0, 0, 0])
        init_N2 = float(Y[iN2, 0, 0, 0]) if iN2 is not None else 0.0
        final_H2O = m.mass[iH2O] / m.mass[iH2] * init_H2
        final_O2 = max(1.0 - final_H2O - init_N2, 0.0)
        YH2 = np.where(x > x1, init_H2 * (TT - T2) / (T1 - T2),
                       init_H2)
        YO2 = np.where(x > x2, final_O2,
                       np.where(x > x1,
                                (x - x1) / (x2 - x1) * (final_O2 - init_O2)
                                + init_O2, init_O2))
        YH2O = np.where(x >= x2, final_H2O,
                        np.where(x >= x1,
                                 (x - x1) / (x2 - x1) * final_H2O, 0.0))
        Y = Y.copy()
        Y[iH2] = YH2[:, None, None]
        Y[iO2] = YO2[:, None, None]
        Y[iH2O] = YH2O[:, None, None]
        Y = Y / Y.sum(axis=0, keepdims=True)
        mu1 = (Y / m.mass[:, None, None, None]).sum(axis=0)
        lnrho = (np.log(self.init_pressure) - np.log(RGAS)
                 - np.log(TT)[:, None, None] - np.log(mu1))
        ux = np.full(shape, self.init_ux)
        uu = np.stack([ux, np.zeros(shape), np.zeros(shape)])
        return {"chem": jnp.asarray(Y),
                "lnTT": jnp.asarray(np.log(TT)[:, None, None]
                                    * np.ones(shape)),
                "lnrho": jnp.asarray(lnrho),
                "uu": jnp.asarray(uu)}


@dataclass(frozen=True)
class TemperatureIonization(ModuleBase):
    """ENERGY slot holder for chemistry runs (reference
    ``src/temperature_ionization.f90``): registers lnTT and owns its
    advection (optionally upwinded) and the viscous-heating intake
    (calc_viscous_heat ltemperature branch: +cv1·TT1·visc_heat); the
    PdV and reactive terms come from the chemistry module."""
    name: ClassVar[str] = "entropy"

    lupw_lnTT: bool = False
    lviscosity_heat: bool = True
    # pure-ionization branch (no chemistry module): PdV work
    # −γ_m1·∇·u/δ (temperature_ionization.f90:109) and uniform heating
    # +ρ⁻¹cv⁻¹T⁻¹·heat_uniform (calc_heat_cool)
    heat_uniform: float = 0.0
    initlnTT: str = "nothing"
    lnTT_const: float = 0.0

    def register(self, reg):
        reg.register("lnTT", 1, "pde")

    def init_fields(self, grid, spec, eos, key, cfg=None):
        import jax.numpy as jnp
        shape = (spec.nx, spec.ny, spec.nz)
        if self.initlnTT in ("const_lnTT", "const-lnTT"):
            return {"lnTT": jnp.full(shape, self.lnTT_const,
                                     grid.x.dtype)}
        if self.initlnTT in ("const_TT", "const-TT"):
            return {"lnTT": jnp.full(shape, math.log(self.lnTT_const),
                                     grid.x.dtype)}
        return {}

    def rhs(self, pen, df, ts):
        if "uu" in pen.reg.slots:
            accumulate(df, "lnTT",
                       -pen.ugrad("lnTT", upwind=self.lupw_lnTT))
        ion = (pen.eos.ion_pencils(pen)
               if hasattr(pen.eos, "ion_pencils") else None)
        if ion is not None and "uu" in pen.reg.slots:
            # PdV with the ionization buffer δ
            # (temperature_ionization.f90:109)
            accumulate(df, "lnTT",
                       -(ion["gamma"] - 1.0) / ion["delta"] * pen.divu())
        if self.heat_uniform != 0.0 and ion is not None:
            accumulate(df, "lnTT", pen.rho1() / ion["cv"] * pen.TT1()
                       * self.heat_uniform)
        heat = pen._cache.get("visc_heat")
        cv = pen._cache.get("cv_mix")
        if cv is None and ion is not None:
            cv = ion["cv"]
        if self.lviscosity_heat and heat is not None and cv is not None:
            accumulate(df, "lnTT", heat / (cv * pen.TT()))
