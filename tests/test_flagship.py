"""The flagship forced isothermal MHD path, its precision reference, sharded
layouts against one device, the compile-cache location, and the CPU
rehearsal of ``chip_smoke.py``."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from pencil_tpu import (BC, Config, Density, EosIdealGas, GridSpec, Hydro,
                        Magnetic, MeshSpec, Model, TimeSpec, Viscosity)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from __graft_entry__ import _flagship_cfg  # noqa: E402


def _fields(state):
    return {k: np.asarray(v, np.float64) for k, v in state["fields"].items()}


def _sharded_vs_single(cfg, mesh, nsteps=3, seed=5):
    single = Model(cfg)
    s1 = single.init_state(seed)
    step1 = single.make_step()
    sharded = Model(dataclasses.replace(cfg, mesh=mesh))
    ss = sharded.shard_state(sharded.init_state(seed),
                             sharded.make_mesh())
    steps = sharded.make_sharded_step(sharded.make_mesh())
    for _ in range(nsteps):
        s1, ss = step1(s1), steps(ss)
    np.testing.assert_allclose(float(ss["dt"]), float(s1["dt"]), rtol=1e-6)
    a, b = _fields(ss), _fields(s1)
    for k in b:
        err = np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)
        assert err < 5e-5, (k, err)


def test_flagship_f32_matches_f64_reference():
    """3 steps at fixed dt in float32 against float64 from one initial
    state, within the tolerance chip_smoke.py applies on the card."""
    errs, tol = chip_smoke.phase_reference(16, "cpu test")
    assert set(errs) == {"uu", "lnrho", "aa"}
    assert all(0.0 < e <= tol for e in errs.values()), (errs, tol)


def test_multi_step_bit_identical_to_single_steps():
    model = Model(_flagship_cfg(n=16))
    s0 = model.init_state(3)
    s1 = s0
    step = model.make_step()
    for _ in range(3):
        s1 = step(s1)
    sk = model.make_multi_step(3)(s0)
    for k in ("t", "dt", "it", "key"):
        np.testing.assert_array_equal(np.asarray(sk[k]), np.asarray(s1[k]))
    for k in s1["fields"]:
        np.testing.assert_array_equal(np.asarray(sk["fields"][k]),
                                      np.asarray(s1["fields"][k]), k)


def test_flagship_sharded_2x2x1_matches_single():
    """chip_smoke's four-device mesh: z whole on each device."""
    _sharded_vs_single(_flagship_cfg(n=16), MeshSpec(2, 2, 1))


def test_conv_slab_zsharded_matches_single():
    """Non-periodic z with symmetric/antisymmetric BCs (the conv-slab
    geometry), z split over four devices."""
    bcz = (BC.parse("ux", "s"), BC.parse("uy", "s"), BC.parse("uz", "a"),
           BC.parse("lnrho", "a2"))
    cfg = Config(
        grid=GridSpec(nx=16, ny=16, nz=16, periodic=(True, True, False)),
        time=TimeSpec(itorder=3),
        modules=(EosIdealGas(gamma=1.4),
                 Density(init="sinwave-x", ampl=0.05),
                 Hydro(init="gaussian-noise", ampl=1e-2),
                 Viscosity(ivisc=("nu-const",), nu=2e-3)),
        bcz=bcz,
    )
    _sharded_vs_single(cfg, MeshSpec(1, 1, 4))


@pytest.mark.parametrize("mesh", [MeshSpec(2, 2, 1), MeshSpec(1, 2, 2)])
def test_shear_shock_sharded_matches_single(mesh):
    """Shearing-periodic x ghosts with the shock-viscosity aux pass and
    MHD, split over x and y or y and z."""
    from pencil_tpu.physics.shear import Shear
    from pencil_tpu.physics.shock import Shock
    cfg = Config(
        grid=GridSpec(nx=16, ny=16, nz=16),
        time=TimeSpec(itorder=3),
        modules=(EosIdealGas(gamma=1.0001),
                 Density(init="gaussian-noise", ampl=1e-2),
                 Hydro(init="gaussian-noise", ampl=1e-2, Omega=1.0),
                 Shear(Omega=1.0, qshear=1.5),
                 Viscosity(ivisc=("nu-const", "nu-shock"), nu=2e-3,
                           nu_shock=1.0),
                 Magnetic(init="gaussian-noise", ampl=1e-4, eta=2e-3),
                 Shock()),
    )
    _sharded_vs_single(cfg, mesh)


def test_compile_cache_uses_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there."""
    cache = tmp_path / "cc"
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import jax, jax.numpy as jnp\n"
        "from pencil_tpu.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(7)).block_until_ready()\n"
    ) % ROOT
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(cache)
    assert any(cache.iterdir())


def test_compile_cache_default_dir_is_fixed_in_checkout(monkeypatch):
    from pencil_tpu import compile_cache
    assert compile_cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs platform 'gpu'" in out.stderr


@pytest.mark.parametrize("devices", [1, 4])
def test_chip_smoke_cpu_rehearsal(devices, tmp_path, capsys):
    """Every phase of chip_smoke.py at 16^3 on the CPU, reached only
    through the rehearsal argument; its output says it is no device
    measurement."""
    verdict = chip_smoke.run(devices, rehearse=True, outdir=str(tmp_path))
    assert verdict["device"]["platform"] == "cpu"
    out = capsys.readouterr().out
    assert "not a device measurement" in out
    if devices == 1:
        assert (tmp_path / "flagship" / "time_series.dat").exists()
        assert "[floor]" in out and "[reference]" in out
    else:
        assert "[sharded]" in out and "mesh 2x2x1" in out


def test_rk_bytes_per_point():
    # flagship: 7 float32 fields, RK3: 3 state reads + 3 state writes,
    # df written twice and read twice
    assert chip_smoke.rk_bytes_per_point(7, 4) == 280
    assert chip_smoke.rk_bytes_per_point(7, 4, nsub=1) == 56


def test_f32_tolerance_scales_with_steps_and_resolution():
    tol = chip_smoke.f32_tolerance
    base = tol(64, 0.05, 1.0, 5e-3, 3)
    assert tol(64, 0.05, 1.0, 5e-3, 6) == pytest.approx(2 * base)
    assert tol(128, 0.05, 1.0, 5e-3, 3) > base
    assert tol(64, 0.0, 1.0, 5e-3, 3) == pytest.approx(
        10 * chip_smoke.EPS32 * 9)


def test_bench_refuses_cpu_without_flag():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert "needs platform 'gpu'" in out.stderr


@pytest.mark.gpu
def test_flagship_reference_on_gpu(gpu):
    """The float32-vs-float64 reference compiled for the card."""
    errs, tol = chip_smoke.phase_reference(64, gpu.device_kind)
    assert all(e <= tol for e in errs.values()), (errs, tol)
