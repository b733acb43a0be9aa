#!/usr/bin/env python3
"""Smoke test of pencil_tpu on NVIDIA GPUs: the flagship forced isothermal
MHD run (``__graft_entry__._flagship_cfg``) through the user entry points.

    python chip_smoke.py                  # one GPU: phases 1-4 at 256^3
    python chip_smoke.py --devices 4      # four GPUs: phase 5 only
    python chip_smoke.py --rehearse-cpu   # the same phases at 16^3 on the
                                          # CPU; prints no verdict line

Phases, in order; any failure raises and the script exits non-zero:
  1 device     a GPU is present; its kind, count, and nvidia-smi's name and
               power limit (from a child process that never imports JAX)
  2 flagship   ``simulate`` 20 steps at 256^3, diagnostics every 10 steps:
               compile time apart from the steady step time, peak device
               memory, the step's memory analysis; fields finite,
               time_series.dat written, u_rms grows, dt set by the CFL
  3 reference  one initial state, fixed dt, 3 steps in float32 and in
               float64 on the card; max relative error of each field
  4 floor      a device-to-device copy of the state, the bytes an RK-2N
               step must move, and the share of the copy rate the step
               reaches
  5 sharded    (--devices 4) 512x512x256 on a 2x2x1 mesh of four GPUs
               against one GPU, and the sharded step time

Every number printed carries the card's name and power limit.  The last
stdout line on success is the JSON verdict
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUTDIR = os.path.join(ROOT, "chip_smoke_out")
NSTEPS_REF = 3
EPS32 = 2.0 ** -23

# 6th-order central weights: Σ|w| of the first and second derivative
SUM_W1 = 2.0 * (45.0 + 9.0 + 1.0) / 60.0
SUM_W2 = (2.0 * (2.0 + 27.0 + 270.0) + 490.0) / 180.0


def f32_tolerance(n, dt, cmax, numax, nsteps, nsub=3):
    """Bound on max|f32 - f64| / max|f64| after ``nsteps`` RK steps of
    ``nsub`` substeps at fixed ``dt`` on an ``n``^3 box of side 2π.

    Every substep rounds the state at float32 epsilon, and one RHS
    evaluation amplifies a rounding error by at most
    dt·3·(Σ|w1|·cmax/dx + Σ|w2|·νmax/dx²): the stencil weights' absolute
    sums times the fastest signal speed and the largest diffusivity, over
    three axes.  The errors of the 3·nsteps substeps add; a factor 10
    covers the products of fields in the nonlinear terms."""
    dx = 2.0 * math.pi / n
    amp = dt * 3.0 * (SUM_W1 * cmax / dx + SUM_W2 * numax / dx ** 2)
    return 10.0 * EPS32 * nsteps * nsub * (1.0 + amp)


def rk_bytes_per_point(nvar, itemsize, nsub=3):
    """Least bytes a 2N-storage RK step moves per grid point: every
    substep reads and writes the state; df is written by every substep
    but the last and read by every substep but the first."""
    return itemsize * nvar * (2 * nsub + 2 * (nsub - 1))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    rows = [r.strip() for r in out.splitlines() if r.strip()]
    if not rows:
        raise RuntimeError("nvidia-smi listed no GPU")
    return rows


def phase_device(rehearse, ndev):
    import jax
    devs = jax.devices()
    d = devs[0]
    want = "cpu" if rehearse else "gpu"
    if d.platform != want:
        raise SystemExit(f"chip_smoke: needs platform {want!r}, JAX found "
                         f"{d.platform!r} ({d.device_kind})")
    if len(devs) < ndev:
        raise SystemExit(f"chip_smoke: needs {ndev} devices, JAX found "
                         f"{len(devs)}")
    print(f"[device] platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    if rehearse:
        tag = "cpu rehearsal, not a device measurement"
    else:
        rows = nvidia_smi()
        print(f"[device] nvidia-smi name, power.limit: {' | '.join(rows)}",
              flush=True)
        tag = rows[0]
    return d, tag


def flagship_cfg(n, mesh=None, dtype="float32", dt=0.0):
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _flagship_cfg
    cfg = _flagship_cfg(n=n, mesh=mesh)
    return dataclasses.replace(
        cfg, dtype=dtype, time=dataclasses.replace(cfg.time, dt=dt))


def _fields_finite(state):
    import jax.numpy as jnp
    return all(bool(jnp.isfinite(v).all()) for v in state["fields"].values())


def phase_flagship(n, tag, outdir):
    from pencil_tpu.io.timeseries import read_time_series
    from pencil_tpu.model import Model
    from pencil_tpu.run import RunParams, simulate

    cfg = flagship_cfg(n)
    datadir = os.path.join(outdir, "flagship")
    shutil.rmtree(datadir, ignore_errors=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            state = simulate(cfg, nt=20, datadir=datadir,
                             params=RunParams(nt=20, it1=10))
    finally:
        print(buf.getvalue(), end="", flush=True)
    wall = time.perf_counter() - t0
    log = buf.getvalue()
    compile_s = float(re.search(r"Compile time \[s\] = (\S+)", log)[1])
    us = float(re.search(
        r"Wall clock time/timestep/meshpoint \[microsec\] = (\S+)", log)[1])
    npts = n ** 3
    print(f"[flagship] {n}^3, 20 steps through simulate(): compile "
          f"{compile_s:.3f} s, steady {us:.6e} us/pt/step (run loop with "
          f"diagnostics and the final checkpoint) = "
          f"{1.0 / (us * 1e-6):.6e} grid-point updates/s, wall {wall:.3f} s "
          f"[{tag}]", flush=True)
    assert _fields_finite(state), "non-finite field after 20 steps"
    ts_path = os.path.join(datadir, "time_series.dat")
    ts = read_time_series(ts_path)
    assert ts["it"] == [0.0, 1.0, 10.0, 20.0], ts["it"]
    assert ts["urms"][-1] > 2.0 * ts["urms"][0], ("u_rms did not grow",
                                                 ts["urms"])
    # sound-crossing CFL of a cube: dt = cdt·dx / (√3·cs0), less by |u|
    cs0 = cfg.module("eos").cs0
    dt_cfl = cfg.time.cdt * cfg.grid.dx / (math.sqrt(3.0) * cs0)
    for dt in ts["dt"][1:]:
        assert 0.5 * dt_cfl < dt <= 1.0001 * dt_cfl, (dt, dt_cfl)
    print(f"[flagship] time_series.dat rows it={ts['it']}, urms "
          f"{ts['urms'][0]:.4e} -> {ts['urms'][-1]:.4e}, dt {ts['dt'][1:]} "
          f"(sound CFL {dt_cfl:.4e}) [{tag}]", flush=True)

    import jax
    stats = jax.devices()[0].memory_stats()
    if stats is not None:
        print(f"[flagship] peak_bytes_in_use {stats['peak_bytes_in_use']} "
              f"[{tag}]", flush=True)
    # the same 10-step scan chunk the run dispatched, timed alone: no
    # diagnostics, checkpoint or host sync between chunks
    model = Model(cfg)
    stepk = model.make_multi_step(10)
    state = model.init_state(0)
    ma = stepk.lower(state).compile().memory_analysis()
    if ma is not None:
        print(f"[flagship] 10-step scan memory_analysis: argument "
              f"{ma.argument_size_in_bytes} output {ma.output_size_in_bytes} "
              f"alias {ma.alias_size_in_bytes} temp {ma.temp_size_in_bytes} "
              f"code {ma.generated_code_size_in_bytes} bytes; state "
              f"{model.reg.nvar * npts * 4} bytes [{tag}]", flush=True)
    state = jax.block_until_ready(stepk(state))
    t0 = time.perf_counter()
    for _ in range(2):
        state = stepk(state)
    jax.block_until_ready(state)
    us_step = (time.perf_counter() - t0) * 1e6 / (20 * npts)
    print(f"[flagship] scan chunks alone: {us_step:.6e} us/pt/step = "
          f"{1.0 / (us_step * 1e-6):.6e} grid-point updates/s, "
          f"{us_step * npts * 1e-3:.3f} ms/step [{tag}]", flush=True)
    return us_step


def phase_reference(n, tag):
    """float32 against float64 from one initial state at fixed dt.  The
    flagship has no matrix product, so TF32 cannot enter."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pencil_tpu.model import Model

    probe = flagship_cfg(n)
    dt = (probe.time.cdt * probe.grid.dx
          / (math.sqrt(3.0) * probe.module("eos").cs0))
    m32 = Model(flagship_cfg(n, dt=dt))
    s0 = jax.device_get(m32.init_state(0))
    step32 = m32.make_step()
    s = s0
    for _ in range(NSTEPS_REF):
        s = step32(s)
    out32 = jax.device_get(s["fields"])
    eos = m32.eos
    visc = probe.module("viscosity")
    mag = probe.module("magnetic")
    umax = max(float(np.abs(v).max()) for v in s0["fields"]["uu"])
    tol = f32_tolerance(n, dt, eos.cs0 + umax, max(visc.nu, mag.eta),
                        NSTEPS_REF)
    with jax.enable_x64(True):
        m64 = Model(flagship_cfg(n, dtype="float64", dt=dt))
        s64 = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64)
            if np.issubdtype(np.asarray(a).dtype, np.floating) else a, s0)
        step64 = m64.make_step()
        for _ in range(NSTEPS_REF):
            s64 = step64(s64)
        assert s64["fields"]["uu"].dtype == jnp.float64
        errs = {}
        for k, ref in s64["fields"].items():
            a = jnp.asarray(out32[k], jnp.float64)
            errs[k] = float(jnp.max(jnp.abs(a - ref))
                            / jnp.maximum(jnp.max(jnp.abs(ref)), 1e-30))
    print(f"[reference] {n}^3, {NSTEPS_REF} steps at fixed dt={dt:.6e}: "
          f"max |f32-f64|/max|f64| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; tolerance {tol:.3e} (float32 eps x {NSTEPS_REF}x3 substeps "
          f"x stencil gain x 10); no matmul in the step, so no TF32 "
          f"[{tag}]", flush=True)
    bad = {k: e for k, e in errs.items() if not e <= tol}
    assert not bad, f"float32 departs from float64 beyond {tol:.3e}: {bad}"
    return errs, tol


def phase_floor(n, tag, us_per_pt_step, nvar=7, reps=20):
    import jax
    import jax.numpy as jnp

    bump = jax.jit(lambda y: y + 1.0)
    x = jnp.ones((nvar, n, n, n), jnp.float32)
    y = bump(x).block_until_ready()
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            y = bump(y)
        y.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / reps)
    copy_bps = 2.0 * x.nbytes / best
    bpp = rk_bytes_per_point(nvar, 4)
    floor_us = bpp / copy_bps * 1e6
    share = floor_us / us_per_pt_step
    print(f"[floor] copy of the {nvar}x{n}^3 float32 state (read+write "
          f"{2 * x.nbytes} bytes, one dispatch each): {best * 1e6:.3f} us, "
          f"{copy_bps / 1e9:.3f} GB/s; RK3-2N lower bound {bpp} bytes per "
          f"point-update -> {floor_us:.6e} us/pt/step at the copy rate; the "
          f"XLA step (scan chunks alone) reaches {share:.4f} of it "
          f"[{tag}]", flush=True)
    return share


def phase_sharded(tag, n_local, nsteps=10):
    """Weak-scaled flagship, n_local^3 per card, on a 2x2x1 mesh: the z
    axis stays whole on each card, so every halo slab is contiguous in
    memory and only x and y faces are exchanged.  Checked against one
    card on the same global grid, or at n_local^3 global when one card
    cannot hold that step."""
    import jax
    import numpy as np
    from pencil_tpu import MeshSpec
    from pencil_tpu.model import Model

    base = flagship_cfg(n_local, mesh=MeshSpec(2, 2, 1))
    g = base.grid
    n = 2 * n_local
    big = Model(dataclasses.replace(base, grid=dataclasses.replace(
        g, nx=n, ny=n, x0=2 * g.x0, y0=2 * g.y0, Lx=2 * g.Lx, Ly=2 * g.Ly)))
    mesh = big.make_mesh(jax.devices()[:4])
    print(f"[sharded] mesh 2x2x1 over {[d.id for d in mesh.devices.flat]}: "
          f"z whole on each card, x/y halos exchanged", flush=True)

    model = big
    single = model.make_step()
    state0 = model.init_state(0)
    ma = single.lower(state0).compile().memory_analysis()
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    need = (None if ma is None else ma.argument_size_in_bytes
            + ma.output_size_in_bytes + ma.temp_size_in_bytes)
    print(f"[sharded] single-device step at {n}x{n}x{n_local} needs {need} "
          f"of {limit} bytes [{tag}]", flush=True)
    if limit is not None and need is not None and need > 0.9 * limit:
        model = Model(base)
        single = model.make_step()
        state0 = model.init_state(0)
    gs = model.cfg.grid
    sharded = model.make_sharded_step(mesh)
    s_sh = model.shard_state(state0, mesh)
    s_1 = state0
    for _ in range(NSTEPS_REF):
        s_sh = sharded(s_sh)
        s_1 = single(s_1)
    a = jax.device_get(s_sh["fields"])
    b = jax.device_get(s_1["fields"])
    errs = {k: float(np.max(np.abs(a[k] - b[k]))
                     / max(float(np.max(np.abs(b[k]))), 1e-30)) for k in b}
    print(f"[sharded] {gs.nx}x{gs.ny}x{gs.nz}, {NSTEPS_REF} steps, mesh "
          f"2x2x1 vs one device: max rel err "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f" (bound 5e-5) [{tag}]", flush=True)
    assert all(e < 5e-5 for e in errs.values()), errs

    if model is not big:
        sharded = big.make_sharded_step(mesh)
        s_sh = sharded(big.shard_state(big.init_state(0), mesh))
    gs = big.cfg.grid
    jax.block_until_ready(s_sh)
    t0 = time.perf_counter()
    for _ in range(nsteps):
        s_sh = sharded(s_sh)
    jax.block_until_ready(s_sh)
    el = time.perf_counter() - t0
    assert _fields_finite(s_sh), "non-finite field in the sharded run"
    npts = gs.nx * gs.ny * gs.nz
    print(f"[sharded] {gs.nx}x{gs.ny}x{gs.nz} on 4 devices, {nsteps} steps: "
          f"{el / nsteps * 1e3:.3f} ms/step, "
          f"{el * 1e6 / (nsteps * npts):.6e} us/pt/step, "
          f"{nsteps * npts / el / 4:.6e} updates/s per device [{tag}]",
          flush=True)
    return errs


def run(devices=1, rehearse=False, outdir=OUTDIR):
    """All phases for ``devices`` (1: phases 1-4, 4: phase 5); returns the
    verdict dict.  ``rehearse`` runs them at 16^3 on the CPU."""
    sys.path.insert(0, ROOT)
    from pencil_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    d, tag = phase_device(rehearse, devices)
    os.makedirs(outdir, exist_ok=True)
    if devices == 4:
        phase_sharded(tag, n_local=8 if rehearse else 256)
    else:
        n = 16 if rehearse else 256
        us = phase_flagship(n, tag, outdir)
        phase_reference(n, tag)
        phase_floor(n, tag, us)
    import jax
    return {"ok": True, "device": {"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(jax.devices())}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: only the sharded phase, on four GPUs")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run the phases at 16^3 on the CPU (no verdict)")
    args = ap.parse_args(argv)
    if args.rehearse_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.devices == 4:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       " --xla_force_host_platform_"
                                       "device_count=4").strip()
    verdict = run(args.devices, args.rehearse_cpu)
    if args.rehearse_cpu:
        print("cpu rehearsal passed; no verdict on the CPU")
        return
    print(json.dumps(verdict), flush=True)


if __name__ == "__main__":
    main()
