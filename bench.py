"""Benchmark: forced isothermal MHD turbulence on one device.

The reference's universal metric is µs per step per mesh point
(src/run.f90:945-951); this prints it beside grid-point updates/s, timed
over scan chunks of steps (the Run driver's between-diagnostics loop).

    python bench.py          # on a GPU; refuses to time anything else
    python bench.py --cpu    # on the CPU, labelled cpu
    PC_BENCH=particles python bench.py   # 128^3 gas + 1e6 TSC particles

BENCH_N, BENCH_STEPS, BENCH_CHUNK and BENCH_NPAR override the sizes.
Prints ONE JSON line naming the device it ran on.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _device(cpu):
    """The device description every result carries; exits unless the run
    is on a GPU, or on the CPU when ``cpu`` asks for it."""
    import jax
    d = jax.devices()[0]
    want = "cpu" if cpu else "gpu"
    if d.platform != want:
        raise SystemExit(f"bench: needs platform {want!r}, JAX found "
                         f"{d.platform!r}" + ("" if cpu else
                                              " (use --cpu to time the CPU)"))
    out = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    if d.platform == "gpu":
        sys.path.insert(0, ROOT)
        from chip_smoke import nvidia_smi
        out["nvidia_smi"] = nvidia_smi()[0]
    return out


def bench_particles(device):
    """PC_BENCH=particles: dusty-turbulence throughput with npar≈1e6 TSC
    particles + drag back-reaction on the gas (the workload the
    reference's brick load balancing exists for,
    src/particles_mpicomm_blocks.f90)."""
    import jax

    on_gpu = device["platform"] == "gpu"
    n = int(os.environ.get("BENCH_N", 128 if on_gpu else 16))
    npar = int(os.environ.get("BENCH_NPAR", 1_000_000 if on_gpu else 10_000))
    nsteps = int(os.environ.get("BENCH_STEPS", 10 if on_gpu else 3))

    from pencil_tpu import (Config, Density, EosIdealGas, GridSpec, Hydro,
                            Model, ParticlesDust, TimeSpec, Viscosity)

    cfg = Config(
        grid=GridSpec(nx=n, ny=n, nz=n),
        time=TimeSpec(itorder=3),
        modules=(EosIdealGas(gamma=1.0001), Density(),
                 Hydro(init="gaussian-noise", ampl=1e-2),
                 Viscosity(ivisc=("nu-const",), nu=2e-3),
                 ParticlesDust(npar=npar, tausp=0.1, eps_dtog=0.01,
                               init="random", scheme="tsc")),
    )
    model = Model(cfg)
    state = model.init_state(0)
    step = model.make_step()
    state = step(state)
    jax.block_until_ready(state["particles"]["vp"])
    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = step(state)
    jax.block_until_ready(state["particles"]["vp"])
    elapsed = time.perf_counter() - t0
    assert np.isfinite(np.asarray(state["particles"]["vp"])).all()
    per_s = nsteps * (npar + n ** 3) / elapsed
    print(json.dumps({
        "metric": f"gas+particle updates/s, {n}^3 hydro + {npar} TSC "
                  f"drag particles w/ back-reaction",
        "value": per_s,
        "unit": "updates/s",
        "steps": nsteps, "npar": npar, "grid": n,
        "device": device,
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(description="single-device benchmark")
    ap.add_argument("--cpu", action="store_true",
                    help="time the CPU (results are labelled cpu)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from pencil_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    device = _device(args.cpu)
    if os.environ.get("PC_BENCH", "") == "particles":
        return bench_particles(device)

    import jax

    on_gpu = device["platform"] == "gpu"
    n = int(os.environ.get("BENCH_N", 256 if on_gpu else 32))
    nsteps = int(os.environ.get("BENCH_STEPS", 20 if on_gpu else 5))
    chunk = int(os.environ.get("BENCH_CHUNK", 10 if on_gpu else 5))
    nwarm = 3

    from __graft_entry__ import _flagship_cfg
    from pencil_tpu import Model

    model = Model(_flagship_cfg(n=n))
    state = model.init_state(0)
    steps = model.make_multi_step(chunk)
    for _ in range(nwarm):
        state = steps(state)
    jax.block_until_ready(state["fields"])

    t0 = time.perf_counter()
    for _ in range(nsteps // chunk):
        state = steps(state)
    jax.block_until_ready(state["fields"])
    elapsed = time.perf_counter() - t0
    nsteps = (nsteps // chunk) * chunk

    npts = n ** 3
    updates_per_s = nsteps * npts / elapsed
    us_per_pt_step = elapsed * 1e6 / (nsteps * npts)
    assert np.isfinite(np.asarray(state["fields"]["uu"])).all()

    print(json.dumps({
        "metric": f"grid-point updates/s, {n}^3 forced isothermal MHD "
                  f"({model.reg.nvar} vars, RK3, 6th-order FD)",
        "value": updates_per_s,
        "unit": "updates/s",
        "us_per_point_step": us_per_pt_step,
        "steps": nsteps,
        "grid": n,
        "device": device,
    }))


if __name__ == "__main__":
    main()
