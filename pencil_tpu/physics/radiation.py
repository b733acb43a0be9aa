"""Radiative transfer by long characteristics (reference
``src/radiation_ray.f90``: ``radtransfer`` :555+ solves dI/dτ = S − I along
discrete ray directions, accumulates Q = Σ_dir w·(I − S)·κρ into the
heating aux ``Qrad``, and pipelines boundary intensities across ranks via
``radboundary_*`` — SURVEY.md §2.7).

JAX-native redesign: the reference works in the RELATIVE intensity
Q = I − S, whose along-ray update (Qintrinsic, radiation_ray.f90:780-904)
is the linear recurrence

    Q_n = e^{−δτ_n}·Q_{n−1} − S'_τ·(1−e^{−δτ}) − S''_τ·(e^{−δτ}(1+δτ)−1)

with δτ from the geometric mean of κρ at consecutive points and S'_τ/S''_τ
the first/second source-function derivatives in optical depth (dtau-
weighted central differences).  A linear recurrence maps exactly onto
``jax.lax.associative_scan`` over the ray axis.  Across a SHARDED ray axis
the reference's rank relay (Qcommunicate :1028, upstream boundary received,
axpy'd, sent downstream) becomes: per-shard prefix scan with zero inflow,
all_gather of each shard's (A, B) transfer planes, and an in-order static
composition handing every shard its true incoming Q — an 8-device mesh
reproduces the single-device sweep exactly.

Periodic rays use the reference's geometric closed form
(Qperiodic :1244): the self-consistent inflow of a closed loop is
Q₀ = B_tot/(1 − A_tot).

Ray set (initialize_radiation :258-370): all directions with components in
{−radx..radx}×{−rady..rady}×{−radz..radz}, 0 < l²+m²+n² ≤ rad2max,
horizontal face diagonals dropped when the xy plane is fully periodic.
Angle weights per ``calc_angle_weights`` :461-553 ('corrected' default:
4π/ndir scaled by dimensionality/3).  Axis rays (rad2 = 1) are scans;
diagonal rays are not implemented (no census sample sets rad2max > 1).

Boundary conditions (radboundary_xy_set :1526): '0', '1', 'S', 'F',
'S+F', 'S−F', 'c' (thermalized layer at TT_top/TT_bot through optical
depth tau_top/tau_bot), 'p' (closed loop).

Source function (source_function :1763): LTE S = (σSB/π)·T⁴, optional
optically-thin tanh cutoff above z_cutoff.  Opacity (opacity :1917):
'Hminus' via the ionization EOS (eoscalc kapparho,
eos_temperature_ionization.f90:850-866), 'kappa_es', 'kappa_cst',
'kapparho_cst', 'total_Rosseland_mean' (:1944-1980, cgs-calibrated
Kramers + H⁻ + conduction harmonic mean).

Heating (radiative_cooling :1608): ds/dt += ρ⁻¹T⁻¹·Qrad (entropy basis)
or dlnT/dt += ρ⁻¹cv⁻¹T⁻¹·Qrad (temperature basis); radiative flux
KR_Frad = Σ w_n·n̂·(Q+S)·κρ feeds the radiative-pressure force
ρ⁻¹·KR_Frad/c (radiative_pressure :1718) and the Fradzm diagnostic
(divided back by κρ)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import jax
import jax.numpy as jnp

from .base import ModuleBase, accumulate


def _combine(x, y):
    ax_, bx = x
    ay, by = y
    return ax_ * ay, by + ay * bx


def _face(arr, axis, last):
    n = arr.shape[axis]
    return (jax.lax.slice_in_dim(arr, n - 1, n, axis=axis) if last
            else jax.lax.slice_in_dim(arr, 0, 1, axis=axis))


def _scan_ray(a, b, ax, reverse, q0, periodic, mesh_name=None, psize=1):
    """Prefix-compose Q_n = a_n·Q_{n−1} + b_n along array axis ``ax`` in
    ray order (``reverse`` = ray runs toward decreasing index), correct
    across a sharded mesh axis.

    ``q0`` is the incoming boundary value (a plane broadcastable against
    the face slice); with ``periodic`` the inflow is the closed-loop
    solution B/(1−A) instead and q0 is ignored."""
    a_s, b_s = jax.lax.associative_scan(_combine, (a, b), axis=ax,
                                        reverse=reverse)
    # shard transfer function: Q_out = At·Q_in + Bt (downstream face)
    At = _face(a_s, ax, last=not reverse)
    Bt = _face(b_s, ax, last=not reverse)

    if mesh_name is not None and psize > 1:
        # relay: gather every shard's transfer planes and compose them
        # in ray order (static loop — psize is small)
        Ag = jax.lax.all_gather(At, mesh_name)
        Bg = jax.lax.all_gather(Bt, mesh_name)
        idx = jax.lax.axis_index(mesh_name)
        order = list(range(psize)) if not reverse \
            else list(range(psize - 1, -1, -1))
        Acum = jnp.ones_like(Ag[0])
        Bcum = jnp.zeros_like(Bg[0])
        myA = jnp.ones_like(Ag[0])
        myB = jnp.zeros_like(Bg[0])
        for p in order:
            sel = (idx == p)
            myA = jnp.where(sel, Acum, myA)
            myB = jnp.where(sel, Bcum, myB)
            Acum, Bcum = Acum * Ag[p], Bg[p] + Ag[p] * Bcum
        if periodic:
            q_bc = Bcum / (1.0 - Acum
                           + jnp.asarray(1e-30, Acum.dtype))
        else:
            # q0 is built from each shard's LOCAL ghost plane; only the
            # upstream-edge shard's carries the physical boundary fill —
            # hand that one to every shard (the reference's rank relay
            # starts from ipstart's radboundary value, Qcommunicate)
            qg = jax.lax.all_gather(q0 + jnp.zeros_like(At), mesh_name)
            q_bc = qg[order[0]]
        q_in = myA * q_bc + myB
    else:
        if periodic:
            q_in = Bt / (1.0 - At + jnp.asarray(1e-30, At.dtype))
        else:
            q_in = q0
    return a_s * q_in + b_s


def _ray_sweep(S, dtau, axis, reverse, periodic, mesh_name=None, psize=1):
    """First-order intensity sweep I_n = e^{−δτ}·I_{n−1} + (1−e^{−δτ})·S_n
    with thermalized inflow (I_in = upstream S) or the periodic closed
    form — the building-block variant kept for the sharded-relay and
    closed-form unit tests."""
    a = jnp.exp(-dtau)
    b = (1.0 - a) * S
    q0 = _face(S, axis, last=reverse)
    return _scan_ray(a, b, axis, reverse, q0, periodic, mesh_name, psize)


def _shift(arr, ax, s):
    """arr at index (i + s) along ax, valid on the interior window of a
    1-ghost slab: slice [g+s : g+s+n]."""
    n = arr.shape[ax] - 2
    return jax.lax.slice_in_dim(arr, 1 + s, 1 + s + n, axis=ax)


def _mid(arr, ax):
    n = arr.shape[ax] - 2
    return jax.lax.slice_in_dim(arr, 1, 1 + n, axis=ax)


@dataclass(frozen=True)
class RadiationRay(ModuleBase):
    name: ClassVar[str] = "radiation"

    # ray-set selection (radiation_ray.f90:101 defaults)
    radx: int = 0
    rady: int = 0
    radz: int = 1
    rad2max: int = 1
    angle_weight: str = "corrected"
    lfix_radweight_1d: bool = True
    # per-axis (lo, hi) boundary markers, parse_bc_rad of bc_rad
    bc_rad: tuple = (("p", "p"), ("p", "p"), ("S", "S"))
    # physics switches
    source_function_type: str = "LTE"
    opacity_type: str = "Hminus"
    lcooling: bool = True
    lradflux: bool = False
    lradpressure: bool = False
    scalefactor_Srad: float = 1.0
    scalefactor_kappa: float = 1.0
    scalefactor_cooling: float = 1.0
    scalefactor_radpressure: float = 1.0
    # opacity parameters
    kappa_cst: float = 1.0
    kapparho_cst: float = 1.0
    kappa_Kconst: float = 1.0
    kapparho_floor: float = 0.0
    kappa_ceiling: float = 1e30
    yMetals: float = 0.0
    # boundary parameters
    Frad_boundary_ref: float = 0.0
    TT_top: float = 0.0
    TT_bot: float = 0.0
    tau_top: float = 0.0
    tau_bot: float = 0.0
    # optically-thin source cutoff (source_function :1796)
    lcutoff_opticallythin: bool = False
    lcutoff_zconst: bool = False
    z_cutoff: float = 0.0
    cool_wid: float = 1.0
    # heating clip (radiative_cooling :1634)
    lno_rad_heating: bool = False
    qrad_max: float = 0.0
    # timestep (radiation_ray.f90:88)
    cdtrad: float = 0.1
    cdtrad_thin: float = 1.0
    cdtrad_thick: float = 0.25
    lcdtrad_old: bool = True
    # physical constants in code units (register.f90:270-310)
    sigmaSB: float = 1.0
    kappa_es: float = 0.0
    c_light: float = 1.0
    unit_length: float = 1.0
    unit_density: float = 1.0
    unit_temperature: float = 1.0
    # direct source-function override S = arad·T⁴ (unit tests / synthetic
    # setups; None → LTE arad = sigmaSB/π)
    arad: float = None
    # extra multiplier on the cooling term (unit-test knob)
    qrad_factor: float = 1.0
    # frequency bins (reference nnu): per-bin opacity multiplier and
    # quadrature weight; empty → single grey bin (radtransfer inu loop)
    kappa_bins: tuple = ()
    weight_bins: tuple = ()
    # shorthand: constant κρ for synthetic setups (maps onto
    # opacity_type='kapparho_cst')
    kapparho_const: float = None

    def _bins(self):
        if not self.kappa_bins:
            return ((1.0, 1.0),)
        w = self.weight_bins or (1.0 / len(self.kappa_bins),) \
            * len(self.kappa_bins)
        return tuple(zip(self.kappa_bins, w))

    def _bc(self, axis, side):
        """bc_rad entry, accepting the tuple form or a single mnemonic
        string applied to every face."""
        if isinstance(self.bc_rad, str):
            return self.bc_rad
        return self.bc_rad[axis][side]

    # ---- ray set --------------------------------------------------------
    def _rays(self):
        """Static list of (l, m, n) axis directions + (weight, weightn)."""
        perio_xy = all(self._bc(ax, sd) == "p"
                       for ax in (0, 1) for sd in (0, 1))
        dirs = []
        for nr in range(-self.radz, self.radz + 1):
            for mr in range(-self.rady, self.rady + 1):
                for lr in range(-self.radx, self.radx + 1):
                    rad2 = lr * lr + mr * mr + nr * nr
                    bad = (rad2 == 2 and nr == 0 and perio_xy)
                    if 0 < rad2 <= self.rad2max and not bad:
                        dirs.append((lr, mr, nr))
        ndir = len(dirs)
        if any(d[0] ** 2 + d[1] ** 2 + d[2] ** 2 > 1 for d in dirs):
            raise NotImplementedError(
                "radiation_ray: diagonal rays (rad2max > 1) not "
                "implemented — axis rays only")
        if self.angle_weight == "corrected":
            cf = (self.radx + self.rady + self.radz) / 3.0
            w = 4.0 * math.pi / max(ndir, 1) * cf
            wn = w
        elif self.angle_weight == "constant":
            w = 4.0 * math.pi / max(ndir, 1)
            wn = w / 3.0 if (self.lfix_radweight_1d and ndir == 2) else w
        else:
            raise NotImplementedError(
                f"angle_weight='{self.angle_weight}'")
        return dirs, w, wn

    # ---- thermodynamics on the ghosted slab -----------------------------
    def _thermo_ghosted(self, pen):
        """(lnrho_g, lnTT_g, yH_g | None) on the full ghosted slab —
        S and κρ need one upstream ghost cell (the reference computes
        Srad/kapparho over n1−radz..n2+radz, source_function :1822)."""
        slots = pen.reg.slots
        eos = pen.eos
        if "lnrho" in slots:
            lnrho_g = pen._gh("lnrho")[0]
        elif "rho" in slots:
            lnrho_g = jnp.log(jnp.maximum(pen._gh("rho")[0], 1e-30))
        else:
            any_name = next(iter(slots))
            lnrho_g = jnp.zeros_like(pen._gh(any_name)[0])
        if "lnTT" in slots:
            lnTT_g = pen._gh("lnTT")[0]
        elif "TT" in slots:
            lnTT_g = jnp.log(jnp.maximum(pen._gh("TT")[0], 1e-30))
        elif "ss" in slots:
            ss_g = pen._gh("ss")[0]
            if hasattr(eos, "solve_arrays"):
                yH_g, lnTT_g = eos.solve_arrays(lnrho_g, ss_g)
                return lnrho_g, lnTT_g, yH_g
            lnTT_g = (eos.lnTT0 + eos.gamma / eos.cp * ss_g
                      + (eos.gamma - 1.0) * (lnrho_g - eos.lnrho0))
        else:
            lnTT_g = jnp.full_like(lnrho_g, getattr(eos, "lnTT0", 0.0))
        yH_g = None
        if hasattr(eos, "yH_arrays"):
            yH_g = eos.yH_arrays(lnrho_g, lnTT_g)
        return lnrho_g, lnTT_g, yH_g

    def _srad(self, pen, lnTT_g, kapparho_g):
        """Source function S = (σSB/π)·T⁴ (initialize_radiation :385
        arad = sigmaSB/pi), optional optically-thin cutoff."""
        if self.source_function_type == "B2":
            # S = B² (calc_Srad_B2, radiation_ray.f90:2231 — flux-ring
            # visualization runs)
            return self._b2_ghosted(pen)
        if self.source_function_type != "LTE":
            raise NotImplementedError(
                f"source_function_type='{self.source_function_type}'")
        arad = (self.arad if self.arad is not None
                else self.sigmaSB / math.pi)
        S = arad * jnp.exp(4.0 * lnTT_g) * self.scalefactor_Srad
        if self.lcutoff_opticallythin:
            if not self.lcutoff_zconst:
                raise NotImplementedError(
                    "lcutoff_opticallythin without lcutoff_zconst")
            zg = self._ghost_z(pen)
            S = S * 0.5 * (1.0 - jnp.tanh((zg - self.z_cutoff)
                                          / self.cool_wid))
        return S

    def _ghost_z(self, pen):
        """Ghosted z coordinate broadcast to (1, 1, mz) — core.grid keeps
        the full ghosted coordinate line in ``grid.z``."""
        return pen.grid.z[None, None, :]

    def _b2_ghosted(self, pen):
        """B² with nearest-interior-layer ghost fill (calc_kapparho_B2,
        radiation_ray.f90:2231-2263)."""
        bb = pen.bb()
        b2 = bb[0] ** 2 + bb[1] ** 2 + bb[2] ** 2
        g = pen.cfg.grid.nghost
        return jnp.pad(b2, ((g, g), (g, g), (g, g)), mode="edge")

    def _kapparho(self, pen, lnrho_g, lnTT_g, yH_g):
        """Ghosted κρ per opacity_type (opacity :1917-2163)."""
        ot = self.opacity_type
        if ot == "B2":
            return self.kapparho_floor + self._b2_ghosted(pen)
        if self.kapparho_const is not None:
            return (self.kapparho_floor
                    + self.kapparho_const * jnp.ones_like(lnrho_g))
        if ot == "Hminus":
            eos = pen.eos
            c = eos.hminus_consts()
            TT1 = jnp.exp(-lnTT_g)
            tmp = (2.0 * lnrho_g - c["lnrho_e"]
                   + 1.5 * (c["lnTT_ion"] - lnTT_g)
                   + c["TT_ion"] * TT1)
            tmpy = yH_g + self.yMetals
            huge_log = (math.log(3e38) if lnrho_g.dtype == jnp.float32
                        else math.log(1e308)) - 5.0
            kr = ((1.0 - yH_g) * c["kappa0"]
                  * jnp.exp(jnp.minimum(tmp, huge_log)
                            + jnp.log(jnp.maximum(tmpy, 1e-30))))
            kr = jnp.where(tmpy <= 0.0, 0.0, kr)
            return self.kapparho_floor + kr * self.scalefactor_kappa
        if ot == "kappa_es":
            return (self.kapparho_floor
                    + self.kappa_es * jnp.exp(lnrho_g))
        if ot == "kappa_cst":
            return (self.kapparho_floor
                    + self.kappa_cst * jnp.exp(lnrho_g))
        if ot == "kapparho_cst":
            return (self.kapparho_floor
                    + self.kapparho_cst * jnp.ones_like(lnrho_g))
        if ot == "kappa_Kconst":
            # kappa = kappa0·T³/ρ with kappa0 = (16/3)σSB/K (:2060)
            kappa0 = 16.0 / 3.0 * self.sigmaSB / self.kappa_Kconst
            return kappa0 * jnp.exp(3.0 * lnTT_g)
        if ot == "total_Rosseland_mean":
            # cgs-calibrated solar-mix opacity (:1944-1980)
            ud, ul, ut = (self.unit_density, self.unit_length,
                          self.unit_temperature)
            rho = jnp.exp(lnrho_g)
            kappa1 = (4.0e25 * 1.7381 * 0.0135 * ud ** 2 * ul
                      * rho * (jnp.exp(lnTT_g) * ut) ** (-3.5))
            kappa2 = (1.25e-29 * 0.0134 * ud ** 1.5 * ul * ut ** 9
                      * jnp.exp(0.5 * lnrho_g) * jnp.exp(9.0 * lnTT_g))
            kappae = (0.2 * 1.7381
                      / (1.0 + 2.7e11 * jnp.exp(lnrho_g - 2.0 * lnTT_g)
                         * ud / ut ** 2))
            kappa_cond = (2.6e-7 * ul * ut ** 2 * jnp.exp(2.0 * lnTT_g)
                          * jnp.exp(-lnrho_g))
            kappa_rad = (self.kapparho_floor
                         + 1.0 / (1.0 / (kappa1 + kappae) + 1.0 / kappa2))
            if self.lcutoff_opticallythin:
                zg = self._ghost_z(pen)
                kappa_tot = (0.5 * (1.0 - jnp.tanh(
                    (zg - 0.5 * self.z_cutoff) / (2.0 * self.cool_wid)))
                    / (1.0 / kappa_rad + 1.0 / kappa_cond))
            else:
                kappa_tot = 1.0 / (1.0 / kappa_rad + 1.0 / kappa_cond)
            kappa_tot = jnp.minimum(kappa_tot, self.kappa_ceiling)
            return rho * kappa_tot * self.scalefactor_kappa
        raise NotImplementedError(f"opacity_type='{ot}'")

    # ---- the transfer solve ---------------------------------------------
    def transfer(self, pen):
        """Cached dict: Qrad (weighted Σ w·Q·κρ, interior), Srad and
        kapparho (interior), KR_Frad (3, interior) or None."""
        return pen.get_cached("radiation", lambda: self._transfer(pen))

    def _crop3(self, pen, arr_g, keep_axis=None):
        """Crop ghost zones (interior), optionally keeping 1 ghost cell
        on ``keep_axis``."""
        g = pen._g
        out = arr_g
        for ax in (0, 1, 2):
            lo, hi = g, arr_g.shape[ax] - g
            if ax == keep_axis:
                lo, hi = g - 1, arr_g.shape[ax] - g + 1
            out = jax.lax.slice_in_dim(out, lo, hi, axis=ax)
        return out

    def _dlength(self, pen, lr, mr, nr, shape_g, dtype):
        """Ray line element per ghosted-z index (Qintrinsic :805):
        sqrt((lrad·dx)² + (mrad·dy)² + (nrad·dz_n)²) — broadcast
        (1, 1, mz)."""
        g = pen.grid
        spec = pen.cfg.grid
        dx = spec.dx
        dy = spec.dy
        if nr != 0 and spec.grid_func[2] != "uniform":
            # nonuniform z: dz_n = 1/dz_1 on the ghosted z line
            dzv = 1.0 / g.dz_1
            dl = jnp.sqrt((lr * dx) ** 2 + (mr * dy) ** 2 + dzv ** 2)
            return dl[None, None, :].astype(dtype)
        dz = spec.dz
        val = math.sqrt((lr * dx) ** 2 + (mr * dy) ** 2 + (nr * dz) ** 2)
        return jnp.asarray(val, dtype)

    def _transfer(self, pen):
        dirs, weight, weightn = self._rays()
        lnrho_g, lnTT_g, yH_g = self._thermo_ghosted(pen)
        K_g0 = self._kapparho(pen, lnrho_g, lnTT_g, yH_g)
        S_g = self._srad(pen, lnTT_g, K_g0)
        dtype = S_g.dtype
        eps_m = jnp.finfo(dtype).eps
        epsi = 5.0 * eps_m
        thresh_min = 1.6 * eps_m ** 0.25
        thresh_max = -math.log(float(jnp.finfo(dtype).tiny))

        names = pen.mesh_axis_names or (None, None, None)
        arad = (self.arad if self.arad is not None
                else self.sigmaSB / math.pi)

        Qtot = 0.0
        Frad = [0.0, 0.0, 0.0] if self.lradflux else None
        K_i0 = self._crop3(pen, K_g0)
        S_i = self._crop3(pen, S_g)

        for kfac, wbin in self._bins():
            acc = {}
            self._sweep_dirs(pen, dirs, weight * wbin, weightn * wbin,
                             S_g, K_g0 * kfac, S_i, K_i0 * kfac, arad,
                             epsi, thresh_min, thresh_max, names, acc)
            Qtot = Qtot + acc["Q"]
            if Frad is not None:
                for j in range(3):
                    Frad[j] = Frad[j] + acc["F"][j]

        if self.lno_rad_heating and self.qrad_max > 0.0:
            Qtot = jnp.minimum(Qtot, self.qrad_max)
        if Frad is not None:
            # components no ray touches stay scalar zero — broadcast
            Frad = jnp.stack([f + jnp.zeros_like(S_i) for f in Frad])
        return dict(Qrad=Qtot, Srad=S_i, kapparho=K_i0, KR_Frad=Frad)

    def _sweep_dirs(self, pen, dirs, weight, weightn, S_g, K_g, S_i, K_i,
                    arad, epsi, thresh_min, thresh_max, names, acc):
        Qtot = 0.0
        Frad = [0.0, 0.0, 0.0]
        dtype = S_g.dtype
        for (lr, mr, nr) in dirs:
            axis = 0 if lr != 0 else (1 if mr != 0 else 2)
            s = (lr, mr, nr)[axis]
            # slabs with 1 ghost cell kept along the ray axis
            Sg1 = self._crop3(pen, S_g, keep_axis=axis)
            Kg1 = self._crop3(pen, K_g, keep_axis=axis)
            dl = self._dlength(pen, lr, mr, nr, S_g.shape, dtype)
            if dl.ndim == 3:   # z-dependent: crop to the same window
                dl1 = jax.lax.slice_in_dim(
                    dl, pen._g - 1, dl.shape[2] - pen._g + 1, axis=2) \
                    if axis == 2 else jax.lax.slice_in_dim(
                        dl, pen._g, dl.shape[2] - pen._g, axis=2)
                dl_g = dl1 + jnp.zeros_like(Kg1)
            else:
                dl_g = dl + jnp.zeros_like(Kg1)

            K_m = _shift(Kg1, axis, -s)
            K_0 = _mid(Kg1, axis)
            K_p = _shift(Kg1, axis, +s)
            dl_m = _shift(dl_g, axis, -s)
            dl_0 = _mid(dl_g, axis)
            dl_p = _shift(dl_g, axis, +s)
            S_m = _shift(Sg1, axis, -s)
            S_0 = _mid(Sg1, axis)
            S_p = _shift(Sg1, axis, +s)

            dtau_m = jnp.maximum(jnp.sqrt(jnp.maximum(K_m * K_0, 0.0))
                                 * 0.5 * (dl_m + dl_0), epsi)
            dtau_p = jnp.maximum(jnp.sqrt(jnp.maximum(K_0 * K_p, 0.0))
                                 * 0.5 * (dl_0 + dl_p), epsi)
            dSdtau_m = (S_0 - S_m) / dtau_m
            dSdtau_p = (S_p - S_0) / dtau_p
            Srad1st = ((dSdtau_p * dtau_m + dSdtau_m * dtau_p)
                       / (dtau_m + dtau_p))
            Srad2nd = 2.0 * (dSdtau_p - dSdtau_m) / (dtau_m + dtau_p)
            # emdtau branches (Qintrinsic :840-855)
            dtau_c = jnp.clip(dtau_m, thresh_min, thresh_max)
            emdtau_x = jnp.exp(-dtau_c)
            emdtau1_x = 1.0 - emdtau_x
            emdtau2_x = emdtau_x * (1.0 + dtau_c) - 1.0
            emdtau1_s = dtau_m * (1.0 - 0.5 * dtau_m
                                  * (1.0 - dtau_m / 3.0))
            emdtau2_s = -dtau_m ** 2 * (0.5 - dtau_m / 3.0)
            small = dtau_m < thresh_min
            big = dtau_m > thresh_max
            emdtau = jnp.where(big, 0.0,
                               jnp.where(small, 1.0 - emdtau1_s, emdtau_x))
            emdtau1 = jnp.where(big, 1.0,
                                jnp.where(small, emdtau1_s, emdtau1_x))
            emdtau2 = jnp.where(big, -1.0,
                                jnp.where(small, emdtau2_s, emdtau2_x))
            a = emdtau
            b = -Srad1st * emdtau1 - Srad2nd * emdtau2

            # upstream boundary Q0 (radboundary_*_set :1432-1606)
            side = 0 if s > 0 else 1
            bc = self._bc(axis, side)
            S_ghost = _face(Sg1, axis, last=(s < 0))
            S_ghost = jax.lax.slice_in_dim(
                S_ghost, 0, 1, axis=axis)  # already a 1-plane
            periodic = (bc == "p")
            if bc == "0":
                q0 = -S_ghost
            elif bc == "1":
                q0 = 1.0 - S_ghost
            elif bc == "S" or periodic:
                q0 = jnp.zeros_like(S_ghost)
            elif bc == "F":
                q0 = (-S_ghost
                      + self.Frad_boundary_ref / (2.0 * weightn))
            elif bc == "S+F":
                q0 = (self.Frad_boundary_ref / (2.0 * weightn)
                      + jnp.zeros_like(S_ghost))
            elif bc == "S-F":
                q0 = (-self.Frad_boundary_ref / (2.0 * weightn)
                      + jnp.zeros_like(S_ghost))
            elif bc == "c":
                # thermalized layer through optical depth tau (:1556)
                mu = s  # axis ray: |unit component| = 1, signed
                if s < 0:
                    I_in = (arad * self.TT_top ** 4
                            * (1.0 - math.exp(self.tau_top / mu)))
                else:
                    I_in = (arad * self.TT_bot ** 4
                            * (1.0 - math.exp(-self.tau_bot / mu)))
                q0 = I_in - S_ghost
            else:
                raise NotImplementedError(f"bc_rad '{bc}'")

            Q = _scan_ray(a, b, axis, reverse=(s < 0), q0=q0,
                          periodic=periodic, mesh_name=names[axis],
                          psize=pen.mesh_shape[axis])
            Qtot = Qtot + weight * Q * K_i
            if self.lradflux:
                Frad[axis] = (Frad[axis] + weightn * float(s)
                              * (Q + S_i) * K_i)
        acc["Q"] = Qtot
        acc["F"] = Frad

    # ---- rhs hooks -------------------------------------------------------
    def rhs(self, pen, df, ts):
        r = self.transfer(pen)
        Q = r["Qrad"] * (self.scalefactor_cooling * self.qrad_factor)
        K = r["kapparho"]
        slots = pen.reg.slots
        if self.lcooling:
            if "ss" in slots:
                accumulate(df, "ss", pen.rho1() * pen.TT1() * Q)
            elif "lnTT" in slots:
                cv = self._cv(pen)
                accumulate(df, "lnTT",
                           pen.rho1() / cv * pen.TT1() * Q)
            elif "TT" in slots:
                cv = self._cv(pen)
                accumulate(df, "TT", pen.rho1() / cv * Q)
            has_energy = bool({"ss", "lnTT", "TT"} & set(slots))
            # radiative cooling timestep (radiative_cooling :1654-1694);
            # no energy equation (noentropy B² visualization runs) → no
            # radiative source and no dtrad constraint
            TT = pen.TT()
            rho1 = pen.rho1()
            kappa = K * rho1
            cv = self._cv(pen)
            g = pen.grid
            dxyz_2 = 0.0
            spec = pen.cfg.grid
            for ax, inv in ((0, g.dx1), (1, g.dy1), (2, g.dz1)):
                if (spec.nx, spec.ny, spec.nz)[ax] > 1:
                    dxyz_2 = dxyz_2 + inv ** 2
            if self.lcdtrad_old:
                base = 4.0 * kappa * self.sigmaSB * TT ** 3 / cv
                thick = K ** 2 > dxyz_2
                dt1_rad = jnp.where(
                    thick, base * dxyz_2 / jnp.maximum(K, 1e-30) ** 2,
                    base) / self.cdtrad
            else:
                dim = sum(1 for n in (spec.nx, spec.ny, spec.nz) if n > 1)
                cgam = 16.0 * self.sigmaSB * TT ** 3 * rho1 / self._cp(pen)
                ell = 1.0 / jnp.maximum(K, 1e-30)
                chi = cgam * ell / 3.0
                dtrad_thick = self.cdtrad_thick / jnp.maximum(
                    dxyz_2 * chi * max(dim, 1), 1e-30)
                dtrad_thin = self.cdtrad_thin * ell / jnp.maximum(
                    cgam, 1e-30)
                dt1_rad = 1.0 / (dtrad_thick + dtrad_thin)
            pen._cache["dt1_rad"] = dt1_rad
            if has_energy:
                ts.max_rate(dt1_rad)
        if self.lradpressure and r["KR_Frad"] is not None \
                and "uu" in slots:
            accumulate(df, "uu",
                       self.scalefactor_radpressure * pen.rho1()[None]
                       * r["KR_Frad"] / self.c_light)

    def _cv(self, pen):
        eos = pen.eos
        if hasattr(eos, "ion_pencils"):
            return eos.ion_pencils(pen)["cv"]
        return getattr(eos, "cv", 1.0)

    def _cp(self, pen):
        eos = pen.eos
        if hasattr(eos, "ion_pencils"):
            return eos.ion_pencils(pen)["cp"]
        return getattr(eos, "cp", 1.0)
