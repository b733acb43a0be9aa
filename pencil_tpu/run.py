"""Host-side run driver — the analog of reference ``src/run.f90``'s
Time_loop (:519-869) plus the ``pc_run`` CLI (L9).

Everything data-dependent-but-slow lives here, outside jit: output cadences
(it1 diagnostics, dsnap snapshots, isave rolling checkpoint), control-file
polling (STOP / SAVE — reference :526-580), dtmin abort with crash dump
(:843-849), and walltime limits.  The jitted step (optionally shard_mapped)
is called in a tight loop; an inner ``steps_per_call`` lets the host batch
device steps between Python round-trips.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np

from .compile_cache import enable_compile_cache
from .io.diagnostics import make_diagnostics
from .io.snapshot import load_snapshot, save_snapshot
from .io.timeseries import TimeSeriesWriter
from .model import Model


@dataclasses.dataclass
class RunParams:
    """run.in-equivalent runtime parameters (reference &run_pars)."""

    nt: int = 100               # number of steps
    it1: int = 10               # diagnostics cadence (steps)
    it_timing: int = 0          # timing.dat cadence (0 = off)
    it1d: int = 0               # 1-D/2-D averages cadence (steps); 0 = off
    isave: int = 200            # rolling var.dat cadence (steps)
    dsnap: float = 0.0          # VAR<N> cadence (sim time); 0 = off
    dvid: float = 0.0           # video-slice cadence (sim time); 0 = off
    dspec: float = 0.0          # power-spectra cadence (sim time); 0 = off
    tmax: float = 1.0e37
    dtmin: float = 1.0e-10
    max_walltime: float = 0.0   # seconds; 0 = unlimited
    print_columns: tuple = ("it", "t", "dt", "urms", "umax", "rhom")
    aver_names: tuple = ()      # e.g. ("uxmz", "rhomz") — see io/averages.py
    phiaver_names: tuple = ()   # e.g. ("uzmphi",) — phi-averages (PHIAVG<n>)
    d2davg: float = 0.0         # 2-D/phi-averages cadence (sim time); 0=off
    tavg: float = 0.0           # time-average window (timeavg.f90); 0 = off
    downsampl: tuple = ()       # e.g. (2, 2, 2) — VARd<N> downsampled snaps
    dsnap_down: float = 0.0     # VARd cadence (defaults to dsnap)
    slice_fields: tuple = ("ux", "uz")
    slice_planes: tuple = ("xy", "xz")
    power_fields: tuple = ()    # e.g. ("kin", "mag")
    sound_points: tuple = ()    # ((x,y,z), ...) probe locations (sound.in)
    sound_fields: tuple = ("ux",)
    dstalk: float = 0.0         # particle-stalker cadence (sim time); 0=off
    npar_stalk: int = 0         # number of stalked particles


class Run:
    def __init__(self, model: Model, datadir="data", params: Optional[RunParams] = None,
                 sharded: bool = False, quiet: bool = False, rundir=None):
        enable_compile_cache()
        self.model = model
        self.rundir = rundir        # enables RELOAD hot-reconfiguration
        self.sharded = sharded
        self.datadir = str(datadir)
        self.params = params or RunParams()
        self.quiet = quiet
        os.makedirs(self.datadir, exist_ok=True)
        cols = []
        for c in self.params.print_columns:
            if isinstance(c, tuple):
                cols.append(c)
            else:
                from .io.timeseries import _DEFAULT_FMT
                cols.append((c, _DEFAULT_FMT.get(c, "E11.3")))
        self.ts_writer = TimeSeriesWriter(
            os.path.join(self.datadir, "time_series.dat"), cols)
        self.diag = make_diagnostics(model, [c[0] for c in cols],
                                     allow_unknown=True)
        self.mesh = model.make_mesh() if sharded else None
        self.step = (model.make_sharded_step(self.mesh) if sharded
                     else model.make_step())
        self._stepk = {}            # chunk size → jitted k-step scan
        self._compiled = set()      # jitted functions already compiled
        self.compile_seconds = 0.0
        self._nsnap = 0
        self._tsnap_last = 0.0
        self._tvid_last = 0.0
        self._tspec_last = 0.0
        self.averages = None
        self.aver_writer = None
        if self.params.aver_names:
            from .io.averages import AveragesWriter, make_averages
            self.averages = make_averages(model, self.params.aver_names)
            self.aver_writer = AveragesWriter(self.datadir,
                                              self.params.aver_names)
        self.phiavg = None
        if self.params.phiaver_names:
            from .io.averages import PhiAvgWriter, make_phi_averages
            ev, rcyl, drcyl = make_phi_averages(model,
                                                self.params.phiaver_names)
            self.phiavg = ev
            self.phiavg_writer = PhiAvgWriter(
                self.datadir, self.params.phiaver_names, model.grid,
                model.cfg.grid, rcyl, drcyl)
        self._t2davg_last = 0.0
        self._tavg_fields = None     # running time average (timeavg.f90)
        self._tsnap_down_last = 0.0
        self._nsnap_down = 0
        self._tstalk_last = -1e30
        self.slices = None
        if self.params.dvid > 0:
            from .io.slices import SliceWriter
            self.slices = SliceWriter(self.datadir, self.params.slice_fields,
                                      self.params.slice_planes)
        self._spec_writers = {}
        if self.params.dspec > 0 and self.params.power_fields:
            from .io.spectra import SpectrumWriter
            for pf in self.params.power_fields:
                self._spec_writers[pf] = SpectrumWriter(
                    os.path.join(self.datadir, f"power_{pf}.dat"))
        # runtime stochastic supernova driver (interstellar check_SN):
        # host-side, fires between device steps — forces chunk=1
        self._sn = None
        ism = next((m for m in model.cfg.modules
                    if getattr(m, "name", "") == "interstellar"), None)
        if ism is not None and "ss" in model.reg.slots:
            from .physics.interstellar import SNScheduler
            sched = SNScheduler(ism, model)
            if sched.active:
                self._sn = sched

    # ------------------------------------------------------------------
    def _control(self, name: str) -> bool:
        p = os.path.join(self.datadir, name)
        if os.path.exists(p):
            os.remove(p)
            return True
        return False

    def _call(self, fn, state):
        """Call a jitted function; its first call is compiled ahead of
        time so that compile time is counted apart from step time."""
        if fn not in self._compiled:
            t0 = time.perf_counter()
            fn.lower(state).compile()
            self.compile_seconds += time.perf_counter() - t0
            self._compiled.add(fn)
        return fn(state)

    def _write_diag(self, state):
        # ONE device→host transfer for the whole row (each float() on a
        # device scalar is a separate sync)
        import jax
        raw = jax.device_get(self._call(self.diag, state))
        vals = {k: float(v) for k, v in raw.items()}
        vals["it"] = int(np.asarray(state["it"]))
        self.ts_writer.append(vals)
        if not self.quiet:
            print(self.ts_writer.format_row(vals), flush=True)
        return vals

    def _checkpoint(self, state, name="var.npz"):
        save_snapshot(os.path.join(self.datadir, name), state)

    def _write_spectra(self, state, t):
        from .io.spectra import shell_spectrum
        spec = self.model.cfg.grid
        for pf, w in self._spec_writers.items():
            if pf == "kin":
                field = state["fields"]["uu"]
            elif pf == "mag":
                # B from A via the diagnostics pencil path
                from .parallel.halo import fill_ghosts
                from .physics.pencils import Pencils
                m = self.model
                fa = m.reg.stack(state["fields"])
                fg = fill_ghosts(fa[: m.reg.ncom], m.cfg.grid,
                                 (m.cfg.bcx, m.cfg.bcy, m.cfg.bcz),
                                 m.reg, m.grid, m.cfg, m.eos)
                field = Pencils(fg, m.grid, m.reg, m.cfg, m.eos).bb()
            else:
                field = state["fields"][pf]
            w.append(t, np.asarray(shell_spectrum(field, spec)))

    def _reload(self, state):
        from .compat.rundir import load_rundir
        cfg, info = load_rundir(self.rundir)
        new_model = Model(cfg)
        if list(new_model.reg.slots) != list(self.model.reg.slots):
            print("RELOAD: slot set changed; keeping old model", flush=True)
            return state
        self.model = new_model
        self.step = (new_model.make_sharded_step(new_model.make_mesh())
                     if self.sharded else new_model.make_step())
        self.diag = make_diagnostics(new_model,
                                     [c[0] for c in self.ts_writer.columns])
        if not self.quiet:
            print("RELOAD: run parameters re-read, step re-jitted", flush=True)
        return state

    def _write_stalker(self, state, t):
        """Trajectory sampling of the first npar_stalk particles
        (reference ``src/particles_stalker.f90``: positions, velocities
        and TSC-interpolated gas quantities at dstalk cadence into
        particles_stalker.dat)."""
        p = self.params
        ps = state.get("particles")
        if ps is None or p.npar_stalk <= 0:
            return
        m = self.model
        n = min(p.npar_stalk, int(np.asarray(ps["xp"]).shape[0]))
        xp = np.asarray(ps["xp"])[:n]
        vp = np.asarray(ps["vp"])[:n]
        # gas state at the stalked particles (lstalk_uu / lstalk_rho)
        from .parallel.halo import fill_ghosts
        from .particles.interp import interpolate
        import jax.numpy as jnp
        fa = m.reg.stack(state["fields"])
        fg = fill_ghosts(fa[: m.reg.ncom], m.cfg.grid,
                         (m.cfg.bcx, m.cfg.bcy, m.cfg.bcz), m.reg,
                         m.grid, m.cfg, m.eos)
        cols = [xp, vp]
        if "uu" in m.reg.slots:
            cols.append(np.asarray(interpolate(
                fg[m.reg.slice("uu")], jnp.asarray(xp), m.cfg.grid,
                "tsc")).T)
        for dens in ("rho", "lnrho"):
            if dens in m.reg.slots:
                r = np.asarray(interpolate(
                    fg[m.reg.slice(dens)], jnp.asarray(xp), m.cfg.grid,
                    "tsc")).T
                cols.append(np.exp(r) if dens == "lnrho" else r)
                break
        data = np.concatenate(cols, axis=1)
        with open(os.path.join(self.datadir, "particles_stalker.dat"),
                  "a") as fh:
            for ipar in range(n):
                row = " ".join(f"{v:.6e}" for v in data[ipar])
                fh.write(f"{t:.6e} {ipar} {row}\n")

    def _write_sound(self, state, t):
        """Point probes (reference write_sound / sound.in,
        src/diagnostics.f90:497-617): one row per sample in sound.dat."""
        gs = self.model.cfg.grid
        vals = [f"{t:.6e}"]
        for (px, py, pz) in self.params.sound_points:
            ix = int((px - gs.x0) / gs.dx) % gs.nx
            iy = int((py - gs.y0) / gs.dy) % gs.ny
            iz = int((pz - gs.z0) / gs.dz) % gs.nz
            for f in self.params.sound_fields:
                arr = state["fields"][("uu" if f.startswith("u") else f)]
                if f in ("ux", "uy", "uz"):
                    v = arr["xyz".index(f[1])][ix, iy, iz]
                else:
                    v = arr[ix, iy, iz]
                vals.append(f"{float(np.asarray(v)):.6e}")
        with open(os.path.join(self.datadir, "sound.dat"), "a") as fh:
            fh.write(" ".join(vals) + "\n")

    # ------------------------------------------------------------------
    def resume(self):
        """Restart from the rolling checkpoint (reference rsnap)."""
        path = os.path.join(self.datadir, "var.npz")
        return load_snapshot(path)

    def _advance(self, state, k):
        """Dispatch k device steps in ONE jitted scan (k=1 → plain step).
        The chunked functions are cached per k; at most three distinct k
        values occur per run (1, it1−1, it1)."""
        if k == 1:
            return self._call(self.step, state)
        if k not in self._stepk:
            self._stepk[k] = self.model.make_multi_step(k, self.mesh)
        return self._call(self._stepk[k], state)

    def _pick_chunk(self, p) -> int:
        """Steps per device dispatch.  Host-side per-step features force 1;
        otherwise chunk to the diagnostics cadence (the reference's it1
        exists precisely so the hot loop isn't synced every step) and align
        any other step-based cadences by gcd.  Time-based cadences (dsnap,
        dvid, dspec, d2davg) are then checked at chunk boundaries — their
        outputs can be at most it1−1 steps late, matching how the reference
        polls control files only at the diagnostic interval."""
        import math
        if p.tavg > 0 or p.sound_points or p.it_timing:
            return 1
        if self._sn is not None:
            return 1      # SN firing checked against t after every step
        chunk = max(1, p.it1)
        for cad in (p.isave, p.it1d):
            if cad:
                chunk = math.gcd(chunk, cad)
        return chunk

    def main_loop(self, state: Dict) -> Dict:
        p = self.params
        t_wall0 = time.time()
        compile0 = self.compile_seconds
        if self.mesh is not None:
            state = self.model.shard_state(state, self.mesh)
        # POSIX signal trap → graceful checkpoint+exit (reference
        # signal_handling.f90 emergency_stop, polled run.f90:524-536):
        # SIGTERM/SIGUSR1 behave like a STOP control file
        self._sigstop = False

        def _emergency(_sig, _frm):
            self._sigstop = True
        import signal as _signal
        try:
            _signal.signal(_signal.SIGTERM, _emergency)
            _signal.signal(_signal.SIGUSR1, _emergency)
        except ValueError:
            pass    # not in the main thread — skip the trap
        it0 = int(np.asarray(state["it"]))
        if not self.quiet:
            print(self.ts_writer.header(), flush=True)
        self._tsnap_last = float(np.asarray(state["t"]))
        if it0 == 0:
            # the reference prints the it=0 diagnostics row before stepping
            # (run.f90 first prints() call) — several samples' reference.out
            # contain ONLY that row
            self._write_diag(state)
        completed = False
        npoints = self.model.cfg.grid.nx * self.model.cfg.grid.ny * self.model.cfg.grid.nz
        chunk = self._pick_chunk(p)
        i = 0
        while i < p.nt:
            # run to the next diagnostics boundary (rows at it=1, it1,
            # 2·it1, … — identical to the step-by-step loop's cadence)
            if chunk == 1:
                k = 1
            else:
                nxt = 1 if i == 0 else (i // chunk + 1) * chunk
                k = min(nxt - i, p.nt - i)
            t_step0 = time.time()
            state = self._advance(state, k)
            i += k
            it = it0 + i
            import jax as _jax
            dt, t = map(float, _jax.device_get((state["dt"], state["t"])))
            if self._sn is not None:
                upd = self._sn({fk: np.asarray(fv) for fk, fv
                                in state["fields"].items()}, t, it)
                if upd is not None:
                    import jax.numpy as _jnp
                    fields = dict(state["fields"])
                    for fk, fv in upd.items():
                        fields[fk] = _jnp.asarray(fv, fields[fk].dtype)
                    state = dict(state, fields=fields)
            # per-step guard, independent of the diagnostics cadence: a
            # blow-up poisons dt through the CFL (reference checks dt and
            # NaN every step, src/run.f90:843; round-1 only checked at it1)
            if not np.isfinite(dt):
                self._checkpoint(state, "crash.npz")
                raise FloatingPointError(f"non-finite dt at it={it}")
            if p.it_timing and it % p.it_timing == 0:
                # timing.dat analog (reference messages.f90:482-544):
                # wall-clock marks per loop phase at it_timing cadence
                with open(os.path.join(self.datadir, "timing.dat"),
                          "a") as fh:
                    fh.write(f"{it} {time.time() - t_wall0:.6f} step "
                             f"{time.time() - t_step0:.6f}\n")
            if i % p.it1 == 0 or i == 1:
                vals = self._write_diag(state)
                if not np.isfinite(vals.get("urms", 0.0)):
                    self._checkpoint(state, "crash.npz")
                    raise FloatingPointError(f"NaN diagnostics at it={it}")
            if dt < p.dtmin:
                # reference: dt<dtmin abort with crash dump (run.f90:843)
                self._checkpoint(state, "crash.npz")
                raise RuntimeError(f"dt={dt} < dtmin={p.dtmin} at it={it}")
            if p.isave and i % p.isave == 0:
                self._checkpoint(state)
            if p.dsnap > 0 and t - self._tsnap_last >= p.dsnap:
                self._nsnap += 1
                self._checkpoint(state, f"VAR{self._nsnap}.npz")
                self._tsnap_last = t
            if p.it1d and i % p.it1d == 0 and self.averages:
                vals = {k: np.asarray(v)
                        for k, v in self.averages(state).items()}
                self.aver_writer.append(t, vals)
            if self.phiavg and p.d2davg > 0 \
                    and t - self._t2davg_last >= p.d2davg:
                self.phiavg_writer.append(t, np.asarray(self.phiavg(state)))
                self._t2davg_last = t
            if p.tavg > 0:
                # exponential time average with weight min(dt/tavg, 1)
                # (reference timeavg.f90:77-88)
                w = min(dt / p.tavg, 1.0)
                cur = {k: np.asarray(v)
                       for k, v in state["fields"].items()}
                if self._tavg_fields is None:
                    self._tavg_fields = cur
                else:
                    self._tavg_fields = {
                        k: a + w * (cur[k] - a)
                        for k, a in self._tavg_fields.items()}
                if p.isave and i % p.isave == 0:
                    np.savez(os.path.join(self.datadir, "timeavg.npz"),
                             t=t, **self._tavg_fields)
            if p.downsampl:
                dd = p.dsnap_down or p.dsnap
                if dd > 0 and t - self._tsnap_down_last >= dd:
                    # downsampled snapshot VARd<N> (reference
                    # run.f90:163-183 ldownsampl + wsnap_down)
                    self._nsnap_down += 1
                    sx, sy, sz = (list(p.downsampl) + [1, 1, 1])[:3]
                    ds = {k: np.asarray(v)[..., ::sx, ::sy, ::sz]
                          for k, v in state["fields"].items()}
                    np.savez(os.path.join(
                        self.datadir, f"VARd{self._nsnap_down}.npz"),
                        t=t, **ds)
                    self._tsnap_down_last = t
            if p.dstalk > 0 and p.npar_stalk > 0 \
                    and t - self._tstalk_last >= p.dstalk:
                self._write_stalker(state, t)
                self._tstalk_last = t
            if self.slices and p.dvid > 0 and t - self._tvid_last >= p.dvid:
                self.slices.capture(self.model, state)
                self._tvid_last = t
            if self._spec_writers and t - self._tspec_last >= p.dspec:
                self._write_spectra(state, t)
                self._tspec_last = t
            if self._sigstop or self._control("STOP"):
                break
            if self._control("SAVE"):
                self._checkpoint(state)
            if self._control("RELOAD") and self.rundir:
                # reference RELOAD: re-read run.in and hot-swap run_pars
                # (src/run.f90:543-580) — here: rebuild model+step, keep state
                state = self._reload(state)
            if self.params.sound_points:
                self._write_sound(state, t)
            if t >= p.tmax:
                completed = True
                break
            if p.max_walltime and time.time() - t_wall0 > p.max_walltime:
                # reference walltime limit (run.f90:853): checkpoint and
                # drop a RESUBMIT marker for the queue wrapper (:533)
                with open(os.path.join(self.datadir, "RESUBMIT"),
                          "w") as fh:
                    fh.write(f"{it}\n")
                break
            if i == 1 or i % p.it1 == 0:
                # per-rank heartbeat (reference run.f90:760-763
                # alive.info — lets external monitors detect hangs)
                with open(os.path.join(self.datadir, "alive.info"),
                          "w") as fh:
                    fh.write(f"it={it} t={t:.6e} wall="
                             f"{time.time() - t_wall0:.1f}\n")
        else:
            completed = True
        if self.slices:
            self.slices.flush()
        self._checkpoint(state)
        compile_s = self.compile_seconds - compile0
        elapsed = time.time() - t_wall0 - compile_s
        nsteps = int(np.asarray(state["it"])) - it0
        if not self.quiet and nsteps > 0:
            us_per_pt_step = elapsed * 1e6 / (nsteps * npoints)
            # the reference's universal metric (src/run.f90:945-951),
            # with compilation counted apart
            print(f"Compile time [s] = {compile_s:.4e}", flush=True)
            print(f"Wall clock time/timestep/meshpoint [microsec] ="
                  f" {us_per_pt_step:.4e}", flush=True)
        if completed:
            open(os.path.join(self.datadir, "COMPLETED"), "w").close()
        return state


def simulate(cfg_or_model, nt=100, datadir="data", seed=0, resume=False,
             params: Optional[RunParams] = None, sharded=False, quiet=False):
    """One-call convenience entry: build, init (or resume), run."""
    model = cfg_or_model if isinstance(cfg_or_model, Model) else Model(cfg_or_model)
    params = params or RunParams()
    params.nt = nt
    run = Run(model, datadir=datadir, params=params, sharded=sharded, quiet=quiet)
    state = run.resume() if resume else model.init_state(seed)
    return run.main_loop(state)
