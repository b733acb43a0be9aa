"""Mean-field EMF from precomputed transport-coefficient tensors
(reference ``src/special/meanfield_e_tensor.f90``).

The reference reads per-point tensors (alpha_ij, beta_ij, gamma_i,
delta_i, kappa_ijk, umean_i, acoef_ij, bcoef_ijk) from
``data/emftensors.h5`` (written by test-field runs or by
``samples/meanfield_special_e_tensor/create_emftensors.py``) and adds

    E = alpha·B + gamma×B − beta·J − delta×J − kappa:(∇B)_sym + Umean×B

to dA/dt (meanfield_e_tensor.f90:1226-1443 calc_pencils_special;
:1856-1885 special_calc_magnetic: ``df(iax:iaz) += emf``).  With
``lusecoefs`` the raw acoef/bcoef pair is used instead:
E = acoef·B + bcoef:∇B (f90:1877-1882).

JAX-native design: the tensors are small per-run constants, so they are
loaded once host-side (HDF5 via h5py, or built analytically for the
dataset names ``create_emftensors.py`` generates, e.g. ``isotropic``) and
closed over the jitted step as broadcastable jnp constants — XLA folds
the contraction into the jitted RHS.  The 'none' time interpolation of the
reference (emf_interpolate takes the FIRST time plane, f90:2370-2378) is
the only mode the shipped samples use and the only one implemented.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import jax.numpy as jnp

from ..base import accumulate
from . import Special, register_special


def _analytic(coef, dataset, rank):
    """Datasets create_emftensors.py can generate without a run dir.

    'isotropic' for a rank-2 coefficient is value*delta_ij with value=1
    (samples/meanfield_special_e_tensor/create_emftensors.py
    values=np.diag([1,1,1])); rank-1/3 datasets named 'zero' are zeros.
    """
    if rank == 2 and dataset in ("isotropic", "identity"):
        return np.eye(3).reshape(3, 3, 1, 1, 1)
    if dataset in ("zero", "nothing", ""):
        shape = (3,) * rank + (1, 1, 1)
        return np.zeros(shape)
    raise NotImplementedError(
        f"meanfield_e_tensor: no emftensors.h5 and no analytic form for "
        f"{coef}/{dataset}")


@register_special("meanfield_e_tensor")
@dataclass(frozen=True, eq=False)
class MeanfieldETensor(Special):
    name: ClassVar[str] = "meanfield_e_tensor"

    lalpha: bool = False
    lbeta: bool = False
    lgamma: bool = False
    ldelta: bool = False
    lkappa: bool = False
    lumean: bool = False
    lacoef: bool = False
    lbcoef: bool = False
    lusecoefs: bool = False
    # per-coefficient dataset names default to 'mean'
    # (meanfield_e_tensor.f90:2387 setParameterDefaults); a global
    # 'dataset'/'dataset_name' overrides all of them (:2432, :2589-2599)
    alpha_name: str = "mean"
    beta_name: str = "mean"
    gamma_name: str = "mean"
    delta_name: str = "mean"
    kappa_name: str = "mean"
    umean_name: str = "mean"
    acoef_name: str = "mean"
    bcoef_name: str = "mean"
    dataset: str = ""
    dataset_name: str = ""
    # 6/3-component selection masks (lalpha_c etc., :2446-2461: the 6
    # entries map to the symmetric (1,1),(2,1)=(1,2),(3,1)=(1,3),(2,2),
    # (2,3)=(3,2),(3,3) pairs); any True implies the tensor is on
    lalpha_c: tuple = ()
    lbeta_c: tuple = ()
    lgamma_c: tuple = ()
    ldelta_c: tuple = ()
    lkappa_c: tuple = ()
    lumean_c: tuple = ()
    lacoef_c: tuple = ()
    lbcoef_c: tuple = ()
    alpha_scale: float = 1.0
    beta_scale: float = 1.0
    gamma_scale: float = 1.0
    delta_scale: float = 1.0
    kappa_scale: float = 1.0
    umean_scale: float = 1.0
    acoef_scale: float = 1.0
    bcoef_scale: float = 1.0
    emftensors_file: str = "emftensors.h5"
    rundir: str = ""
    # post-load processing (meanfield_e_tensor.f90 special_before_boundary
    # :915-1195): Viviani et al. 2019 alternative decomposition from raw
    # acoef/bcoef, diagonal-beta floor, kappa component floor, equatorial
    # symmetrization with the per-component parity tables (:94-109)
    lalt_decomp: bool = False
    lremove_beta_negativ: bool = False
    rel_eta: float = 0.0
    lregularize_kappa_simple: bool = False
    kappa_floor: float = -1e-5
    lsymmetrize: bool = False

    def _on(self, coef):
        """Tensor enabled? (l<coef> or any component of l<coef>_c)."""
        return getattr(self, f"l{coef}") or any(
            bool(v) for v in getattr(self, f"l{coef}_c"))

    def _mask(self, coef, rank):
        """Component mask as a float array (l<coef>_c mapping,
        meanfield_e_tensor.f90:2446-2461); all-ones when no _c given."""
        c = [bool(v) for v in getattr(self, f"l{coef}_c")]
        if not any(c):
            return np.ones((3,) * rank)
        if rank == 1:
            m = np.zeros(3)
            for i in range(min(3, len(c))):
                m[i] = c[i]
            return m
        m = np.zeros((3, 3))
        pairs = [((0, 0),), ((1, 0), (0, 1)), ((2, 0), (0, 2)),
                 ((1, 1),), ((1, 2), (2, 1)), ((2, 2),)]
        for ci, locs in enumerate(pairs):
            if ci < len(c) and c[ci]:
                for i, j in locs:
                    m[i, j] = 1.0
        if rank == 3:
            return np.repeat(m[:, :, None], 3, axis=2)
        return m

    # ---- tensor loading --------------------------------------------------
    def _load(self, coef, dataset, scale, rank):
        """Return coefficient as (3,..,nx|1,ny|1,nz|1) numpy array."""
        path = None
        for cand in (os.path.join(self.rundir, "data", self.emftensors_file),
                     os.path.join(self.rundir, self.emftensors_file)):
            if self.rundir and os.path.exists(cand):
                path = cand
                break
        if path is None:
            data = _analytic(coef, dataset, rank)
        else:
            import h5py
            with h5py.File(path, "r") as h5:
                grp = h5["emftensor"]
                # alternate datagroup names (openDataset's datagroup_
                # candidates: umean is stored as 'utensor' by some
                # producers)
                gname = coef
                if gname not in grp and coef == "umean":
                    gname = "utensor"
                ds = grp[f"{gname}/{dataset}"]
                # dims are (coef..., z, y, x, t) — create_emftensors.py
                # labelDataset; take the first time plane ('none' interp)
                data = np.asarray(ds[..., 0])
            # (..., z, y, x) -> (..., x, y, z)
            data = np.moveaxis(data, (-3, -2, -1), (-1, -2, -3))
            # Fortran tensor dims (..., i, j[, k]) come out of HDF5
            # REVERSED: leading dims are (k, j, i) — restore (i, j, k)
            if rank == 2:
                data = np.swapaxes(data, 0, 1)
            elif rank == 3:
                data = np.transpose(data, (2, 1, 0, 3, 4, 5))
        return scale * data

    def _ensure(self, pen):
        """Run the one-time post-load processing (special_before_boundary)
        on the coefficient cache using the run grid from ``pen``."""
        d = self.__dict__
        if d.get("_prepared") or not (
                self.lalt_decomp or self.lremove_beta_negativ
                or self.lregularize_kappa_simple or self.lsymmetrize):
            d["_prepared"] = True
            return
        cache = d.setdefault("_coef_cache", {})
        ranks = dict(alpha=2, beta=2, gamma=1, delta=1, kappa=3,
                     umean=1, acoef=2, bcoef=3)
        raw = {}
        for c, r in ranks.items():
            if self._on(c):
                name = (self.dataset_name or self.dataset
                        or getattr(self, f"{c}_name"))
                # UNscaled, unmasked raw tensors — scales apply after the
                # decomposition like the reference (:980-984)
                raw[c] = self._load(c, name, 1.0, r)
        # STATIC numpy coordinates rebuilt from the GridSpec (pen.grid
        # arrays ride traced through jit)
        from ...core.grid import _axis_coords
        gs = pen.cfg.grid
        sh = [0.5 * dd if ls else 0.0 for ls, dd in
              zip(gs.lshift_origin, (gs.dx, gs.dy, gs.dz))]
        xi, _, _ = _axis_coords(gs.nx, gs.x0 + sh[0], gs.Lx,
                                gs.periodic[0], gs.nghost,
                                gs.grid_func[0], gs.grid_coeff[0],
                                np.float64)
        yi, _, _ = _axis_coords(gs.ny, gs.y0 + sh[1], gs.Ly,
                                gs.periodic[1] or gs.lpole[1], gs.nghost,
                                gs.grid_func[1], gs.grid_coeff[1],
                                np.float64)
        xi = xi[gs.nghost:-gs.nghost]
        yi = yi[gs.nghost:-gs.nghost]
        r_ = xi[:, None, None]
        cot = (np.cos(yi) / np.sin(yi))[None, :, None]
        if self.lalt_decomp and "acoef" in raw and "bcoef" in raw:
            a, b = raw["acoef"], raw["bcoef"]
            al = np.zeros_like(a)
            al[0, 0] = a[0, 0] - b[0, 1, 1] / r_
            al[0, 1] = 0.5 * (a[0, 1] + b[0, 0, 1] / r_
                              + a[1, 0] - b[1, 1, 1] / r_)
            al[1, 1] = a[1, 1] + b[1, 0, 1] / r_
            al[0, 2] = 0.5 * (a[0, 2] + a[2, 0]
                              - (b[2, 1, 1] + b[0, 2, 0]
                                 + cot * b[0, 2, 1]) / r_)
            al[1, 2] = 0.5 * (a[1, 2] + a[2, 1]
                              - (b[1, 2, 0] - b[2, 0, 1]
                                 + cot * b[1, 2, 1]) / r_)
            al[2, 2] = a[2, 2] - (b[2, 2, 0] + cot * b[2, 2, 1]) / r_
            ga = np.zeros_like(raw.get("gamma", np.zeros((3,) + a.shape[2:])))
            ga[0] = 0.5 * (a[2, 1] - a[1, 2]
                           + (b[1, 2, 0] + b[2, 0, 1]
                              + cot * b[1, 2, 1]) / r_)
            ga[1] = 0.5 * (a[0, 2] - a[2, 0]
                           - (b[0, 2, 0] - b[2, 1, 1]
                              + cot * b[0, 2, 1]) / r_)
            ga[2] = 0.5 * (a[1, 0] - a[0, 1]
                           - (b[0, 0, 1] + b[1, 1, 1]) / r_)
            de = np.zeros_like(ga)
            de[0] = 0.25 * (b[1, 1, 0] - b[1, 0, 1] + 2.0 * b[2, 2, 0])
            de[1] = 0.25 * (b[0, 0, 1] - b[0, 1, 0] + 2.0 * b[2, 2, 1])
            de[2] = -0.5 * (b[0, 2, 0] + b[1, 2, 1])
            be = np.zeros_like(a)
            be[0, 0] = -b[0, 2, 1]
            be[1, 1] = b[1, 2, 0]
            be[2, 2] = 0.5 * (-b[2, 1, 0] + b[2, 0, 1])
            be[0, 1] = 0.5 * (-b[1, 2, 1] + b[0, 2, 0])
            be[0, 2] = 0.25 * (-2.0 * b[2, 2, 1] + b[0, 0, 1]
                               - b[0, 1, 0])
            be[1, 2] = 0.25 * (2.0 * b[2, 2, 0] + b[1, 0, 1]
                               - b[1, 1, 0])
            for (i, j) in ((1, 0), (2, 0), (2, 1)):
                al[i, j] = al[j, i]
                be[i, j] = be[j, i]
            raw["alpha"], raw["gamma"], raw["delta"], raw["beta"] = \
                al, ga, de, be
            if "kappa" in raw:
                raw["kappa"][:, :, 2] = 0.0
                raw["kappa"][:, 2, :] = 0.0
        if self.lremove_beta_negativ and "beta" in raw:
            mag = pen.cfg.module("magnetic")
            floor = float(getattr(mag, "eta", 0.0)) * self.rel_eta
            for i in range(3):
                raw["beta"][i, i] = np.maximum(raw["beta"][i, i], floor)
        if self.lregularize_kappa_simple and "kappa" in raw:
            # kappa_{φrθ} and kappa_{φθr} floored by hand (:1170-1175)
            raw["kappa"][2, 0, 1] = np.maximum(raw["kappa"][2, 0, 1],
                                               self.kappa_floor)
            raw["kappa"][2, 1, 0] = np.maximum(raw["kappa"][2, 1, 0],
                                               self.kappa_floor)
        if self.lsymmetrize:
            # equatorial parities (:94-109): alpha sym ⟺ i+j odd (0-based),
            # beta the complement; gamma/umean [T,F,T], delta [F,T,F];
            # kappa sym ⟺ i+j+k odd (0-based)
            def symz(arr, sym, yax):
                fl = np.flip(arr, axis=yax)
                return 0.5 * (arr + fl) if sym else 0.5 * (arr - fl)
            for c, r in ranks.items():
                if c not in raw or c in ("acoef", "bcoef"):
                    continue
                arr = raw[c]
                yax = arr.ndim - 2
                if r == 1:
                    for i in range(3):
                        arr[i] = symz(arr[i], (i % 2 == 0)
                                      ^ (c == "delta"), yax - 1)
                elif r == 2:
                    for i in range(3):
                        for j in range(3):
                            arr[i, j] = symz(
                                arr[i, j],
                                ((i + j) % 2 == 1) ^ (c == "beta"),
                                yax - 2)
                else:
                    for i in range(3):
                        for j in range(3):
                            for k in range(3):
                                arr[i, j, k] = symz(
                                    arr[i, j, k],
                                    (i + j + k) % 2 == 1, yax - 3)
        for c in raw:
            m = self._mask(c, ranks[c])
            sc = getattr(self, f"{c}_scale")
            cache[c] = sc * raw[c] * m.reshape(
                m.shape + (1,) * (raw[c].ndim - m.ndim))
        d["_prepared"] = True

    def _coef(self, key, rank):
        cache = self.__dict__.setdefault("_coef_cache", {})
        if key not in cache:
            name = (self.dataset_name or self.dataset
                    or getattr(self, f"{key}_name"))
            data = self._load(key, name,
                              getattr(self, f"{key}_scale"), rank)
            m = self._mask(key, rank)
            cache[key] = data * m.reshape(m.shape + (1,) * (data.ndim
                                                            - m.ndim))
        return cache[key]

    # ---- EMF -------------------------------------------------------------
    def emf(self, pen):
        self._ensure(pen)
        bb = pen.bb()
        dt = bb.dtype
        emf = jnp.zeros_like(bb)
        if self.lusecoefs:
            if self._on("acoef"):
                a = jnp.asarray(self._coef("acoef", 2), dt)
                emf = emf + jnp.einsum("ij...,j...->i...", a, bb)
            if self._on("bcoef"):
                b = jnp.asarray(self._coef("bcoef", 3), dt)
                bij = pen.bij()
                emf = emf + jnp.einsum("ijk...,jk...->i...", b, bij)
            if self._on("umean"):
                u = jnp.asarray(self._coef("umean", 1), dt)
                emf = emf + jnp.cross(u, bb, axis=0)
            return emf
        if self._on("alpha"):
            a = jnp.asarray(self._coef("alpha", 2), dt)
            emf = emf + jnp.einsum("ij...,j...->i...", a, bb)
        if self._on("beta"):
            b = jnp.asarray(self._coef("beta", 2), dt)
            emf = emf - jnp.einsum("ij...,j...->i...", b, pen.jj())
        if self._on("gamma"):
            g = jnp.asarray(self._coef("gamma", 1), dt)
            emf = emf + jnp.cross(jnp.broadcast_to(g, bb.shape), bb, axis=0)
        if self._on("delta"):
            d = jnp.asarray(self._coef("delta", 1), dt)
            jj = pen.jj()
            emf = emf - jnp.cross(jnp.broadcast_to(d, bb.shape), jj, axis=0)
        if self._on("kappa"):
            k = jnp.asarray(self._coef("kappa", 3), dt)
            bij = pen.bij()
            bsym = 0.5 * (bij + jnp.swapaxes(bij, 0, 1))
            emf = emf - jnp.einsum("ijk...,jk...->i...", k, bsym)
        if self._on("umean"):
            u = jnp.asarray(self._coef("umean", 1), dt)
            emf = emf + jnp.cross(jnp.broadcast_to(u, bb.shape), bb, axis=0)
        return emf

    def cfl_special(self, pen):
        """(advec_special, diffus_special) per point — the EMF transport
        coefficients' timestep classes (meanfield_e_tensor.f90:1889-1935:
        Σ_j |α_ij|d1_j + |γ|·d1 + |ū|·d1; d1·|β|·d1 + d1·(d1×|δ|) +
        d1·(d1·|κ|)·d1 — all with dline_1 folded in)."""
        self._ensure(pen)
        d1 = pen.dline_1()
        dt_ = pen.fg.dtype
        shape = jnp.broadcast_shapes(jnp.shape(d1[0]), jnp.shape(d1[1]),
                                     jnp.shape(d1[2]))
        adv = jnp.zeros(shape, dt_)
        dif = jnp.zeros(shape, dt_)
        d1v = jnp.stack([jnp.broadcast_to(
            jnp.asarray(d1[a], dt_), shape) for a in range(3)])
        if self._on("alpha"):
            a = jnp.abs(jnp.asarray(self._coef("alpha", 2), dt_))
            adv = adv + jnp.einsum("j...,ij...->...", d1v, a)
        if self._on("gamma"):
            g = jnp.abs(jnp.asarray(self._coef("gamma", 1), dt_))
            adv = adv + jnp.einsum("j...,j...->...", d1v,
                                   jnp.broadcast_to(g, d1v.shape))
        if self._on("umean"):
            u = jnp.abs(jnp.asarray(self._coef("umean", 1), dt_))
            adv = adv + jnp.einsum("j...,j...->...", d1v,
                                   jnp.broadcast_to(u, d1v.shape))
        if self._on("beta"):
            b = jnp.abs(jnp.asarray(self._coef("beta", 2), dt_))
            t = jnp.einsum("j...,ij...->i...", d1v, b)
            dif = dif + jnp.einsum("i...,i...->...", d1v, t)
        if self._on("delta"):
            de = jnp.abs(jnp.asarray(self._coef("delta", 1), dt_))
            t = jnp.cross(d1v, jnp.broadcast_to(de, d1v.shape), axis=0)
            dif = dif + jnp.einsum("i...,i...->...", d1v, t)
        if self._on("kappa"):
            k = jnp.abs(jnp.asarray(self._coef("kappa", 3), dt_))
            t = jnp.einsum("i...,ijk...->jk...", d1v, k)
            dif = dif + jnp.einsum("k...,jk...->...", d1v, t)
        return adv, dif

    def rhs(self, pen, df, ts):
        if "aa" not in pen.reg.slots:
            return
        accumulate(df, "aa", self.emf(pen))
        adv, dif = self.cfl_special(pen)
        ts.advec(adv)
        ts.diffus_scaled(dif)


# ---- diagnostics ----------------------------------------------------------
from ...io.diagnostics import DIAG_REGISTRY, _vmean, _vrms  # noqa: E402


def _emf_of(pen):
    sp = pen.cfg.module("meanfield_e_tensor")
    return None if sp is None else sp.emf(pen)


def _reg_emf_diags():
    def emfrms(pen, st):
        e = _emf_of(pen)
        return _vrms(pen, jnp.sum(e * e, axis=0))

    def alpharms(pen, st):
        sp = pen.cfg.module("meanfield_e_tensor")
        a = jnp.asarray(sp._coef("alpha", 2), pen.bb().dtype)
        bb = pen.bb()
        ae = jnp.einsum("ij...,j...->i...", a, bb)
        return _vrms(pen, jnp.sum(ae * ae, axis=0))

    def emfcoef(pen):
        """EMF from the raw acoef/bcoef pair (meanfield_e_tensor.f90
        :1877-1882): E = acoef·B + bcoef:∇B."""
        sp = pen.cfg.module("meanfield_e_tensor")
        sp._ensure(pen)
        bb = pen.bb()
        e = jnp.zeros_like(bb)
        if sp._on("acoef"):
            a = jnp.asarray(sp._coef("acoef", 2), bb.dtype)
            e = e + jnp.einsum("ij...,j...->i...", a, bb)
        if sp._on("bcoef"):
            b = jnp.asarray(sp._coef("bcoef", 3), bb.dtype)
            e = e + jnp.einsum("ijk...,jk...->i...", b, pen.bij())
        if sp._on("umean"):
            u = jnp.asarray(sp._coef("umean", 1), bb.dtype)
            e = e + jnp.cross(jnp.broadcast_to(u, bb.shape), bb, axis=0)
        return e

    def emfcoefrms(pen, st):
        e = emfcoef(pen)
        return _vrms(pen, jnp.sum(e * e, axis=0))

    def dtemf_ave(pen, st):
        adv, _ = pen.cfg.module("meanfield_e_tensor").cfl_special(pen)
        return st["dt"] * jnp.max(adv) / pen.cfg.time.cdt

    def dtemf_dif(pen, st):
        _, dif = pen.cfg.module("meanfield_e_tensor").cfl_special(pen)
        return st["dt"] * jnp.max(dif) / pen.cfg.time.cdtv

    DIAG_REGISTRY.setdefault("emfrms", emfrms)
    DIAG_REGISTRY.setdefault("alpharms", alpharms)
    DIAG_REGISTRY.setdefault("emfcoefrms", emfcoefrms)
    DIAG_REGISTRY.setdefault("dtemf_ave", dtemf_ave)
    DIAG_REGISTRY.setdefault("dtemf_dif", dtemf_dif)

    def emfdiffmax(pen, st):
        sp = pen.cfg.module("meanfield_e_tensor")
        if sp.lusecoefs:
            d = emfcoef(pen) - _emf_of(pen)
            return jnp.sqrt(jnp.max(jnp.sum(d * d, axis=0)))
        # emftmp == p%emf when the decomposed EMF drives dA/dt → 0
        return jnp.zeros(())

    DIAG_REGISTRY.setdefault("emfdiffmax", emfdiffmax)
    for i, c in enumerate("xyz"):
        def emfmax(pen, st, i=i):
            return jnp.max(jnp.abs(_emf_of(pen)[i]))
        DIAG_REGISTRY.setdefault(f"emf{c}max", emfmax)

        def emfdiffcmax(pen, st, i=i):
            sp = pen.cfg.module("meanfield_e_tensor")
            if sp.lusecoefs:
                return jnp.max(jnp.abs(emfcoef(pen)[i]
                                       - _emf_of(pen)[i]))
            return jnp.zeros(())
        DIAG_REGISTRY.setdefault(f"emf{c}diffmax", emfdiffcmax)

        def alphamax(pen, st, i=i):
            sp = pen.cfg.module("meanfield_e_tensor")
            sp._ensure(pen)
            a = jnp.asarray(sp._coef("alpha", 2), pen.bb().dtype)
            ae = jnp.einsum("ij...,j...->i...", a, pen.bb())
            return jnp.max(ae[i])
        DIAG_REGISTRY.setdefault(f"alpha{c}max", alphamax)


_reg_emf_diags()
