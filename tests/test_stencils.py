"""Stencil-operator unit tests: analytic derivatives of trig/polynomial
fields (the reference lacks these at the Fortran level; SURVEY.md §4)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pencil_tpu.ops import stencil as st


def _ghosted_sin(n=48, k=2):
    # periodic sin(kx) on [0, 2pi), ghosted by wrap
    dx = 2 * np.pi / n
    x = dx * np.arange(-3, n + 3)
    f = np.sin(k * x)[:, None, None] * np.ones((1, 8, 8))
    fg = np.pad(f, ((0, 0), (3, 3), (3, 3)), mode="wrap")
    # x-axis ghosts are already correct via analytic extension
    return jnp.asarray(fg[None]), x, dx


def test_fd_weights_first():
    w = st.fd_weights(st.central_offsets(3), 1)
    np.testing.assert_allclose(
        w, [-1 / 60, 9 / 60, -45 / 60, 0, 45 / 60, -9 / 60, 1 / 60], atol=1e-12
    )


def test_fd_weights_second():
    w = st.fd_weights(st.central_offsets(3), 2)
    np.testing.assert_allclose(
        w, [2 / 180, -27 / 180, 270 / 180, -490 / 180, 270 / 180, -27 / 180, 2 / 180],
        atol=1e-12,
    )


def test_fd_weights_sixth():
    w = st.fd_weights(st.central_offsets(3), 6)
    np.testing.assert_allclose(w, [1, -6, 15, -20, 15, -6, 1], atol=1e-9)


@pytest.mark.parametrize("deriv,fn", [(1, "der"), (2, "der2")])
def test_der_sin_accuracy(deriv, fn):
    fg, x, dx = _ghosted_sin(n=64, k=3)
    inv = 1.0 / dx
    out = getattr(st, fn)(fg, 0, inv)
    out = st.i(out, (1, 2))
    xi = x[3:-3]
    if deriv == 1:
        exact = 3 * np.cos(3 * xi)
    else:
        exact = -9 * np.sin(3 * xi)
    err = np.abs(np.asarray(out[0, :, 0, 0]) - exact).max()
    assert err < 5e-4, err


def test_der_convergence_order():
    """6th-order convergence of the der weights on sin(x) (float64 —
    the f32 path bottoms out at roundoff, covered by the accuracy test)."""
    w = np.asarray(st.fd_weights(st.central_offsets(3), 1))
    errs = []
    for n in (32, 64):
        dx = 2 * np.pi / n
        x = dx * np.arange(-3, n + 3)
        f = np.sin(x)
        d = sum(w[k] * f[k:k + n] for k in range(7)) / dx
        errs.append(np.abs(d - np.cos(x[3:-3])).max())
    order = np.log2(errs[0] / errs[1])
    assert order > 5.8, (errs, order)


def test_der_axes_consistent():
    """der along y and z matches der along x of the transposed field."""
    rng = np.random.default_rng(0)
    n = 16
    f = rng.standard_normal((n, n, n))
    fg = jnp.asarray(np.pad(f, 3, mode="wrap")[None])
    dx = 0.1
    dfx = np.asarray(st.i(st.der(fg, 0, 1 / dx), (1, 2))[0])
    ft = jnp.asarray(np.pad(f.transpose(1, 2, 0), 3, mode="wrap")[None])
    dfy_t = np.asarray(st.i(st.der(ft, 2, 1 / dx), (0, 1))[0])
    np.testing.assert_allclose(dfx, dfy_t.transpose(2, 0, 1), rtol=2e-5, atol=1e-6)


def test_derij_symmetric():
    rng = np.random.default_rng(1)
    n = 16
    f = rng.standard_normal((n, n, n))
    fg = jnp.asarray(np.pad(f, 3, mode="wrap")[None])
    d01 = np.asarray(st.i(st.derij(fg, 0, 1, 1.0, 1.0), (2,)))
    d10 = np.asarray(st.i(st.derij(fg, 1, 0, 1.0, 1.0), (2,)))
    np.testing.assert_allclose(d01, d10, rtol=1e-5, atol=1e-6)


def test_der6_damps_nyquist():
    """δ⁶ of the Nyquist mode (-1)^i is -64·2·... strongly negative."""
    n = 16
    f = np.cos(np.pi * np.arange(n))  # (-1)^i
    f3 = f[:, None, None] * np.ones((1, 4, 4))
    fg = jnp.asarray(np.pad(f3, ((3, 3), (3, 3), (3, 3)), mode="wrap")[None])
    out = np.asarray(st.i(st.der6(fg, 0, 1.0), (1, 2))[0])
    # delta^6 of (-1)^i = -64 * (-1)^i ... sign opposes the field
    assert (out[:, 0, 0] * f < 0).all()
    np.testing.assert_allclose(np.abs(out[:, 0, 0]), 64.0, rtol=1e-5)


def test_stretched_grid_derivatives():
    """sinh-stretched z grid: der and der2 of sin(z) via the metric vectors
    match the analytic derivatives (reference nonuniform-grid rule,
    src/deriv.f90:141-160)."""
    import jax.numpy as jnp
    from pencil_tpu.core.config import Config, GridSpec
    from pencil_tpu.core.farray import Registry
    from pencil_tpu.core.grid import make_grid
    from pencil_tpu.physics.pencils import Pencils

    # cluster at the box centre (reference xyz_star semantics: the
    # default x_star=0 would cluster at the LEFT edge of this 0..3 box)
    spec = GridSpec(nx=4, ny=4, nz=96, z0=0.0, Lz=3.0,
                    periodic=(True, True, False),
                    grid_func=("uniform", "uniform", "sinh"),
                    grid_coeff=(0.0, 0.0, 1.0),
                    xyz_star=(0.0, 0.0, 1.5))
    cfg = Config(grid=spec)
    grid = make_grid(spec, jnp.float32)
    z = np.asarray(grid.z, np.float64)
    # grid really is stretched: sinh clusters points toward the centre
    dz_edge = z[4] - z[3]
    dz_mid = z[len(z) // 2 + 1] - z[len(z) // 2]
    assert dz_edge > 2.0 * dz_mid
    f = np.broadcast_to(np.sin(z)[None, None, :], (10, 10, len(z)))
    reg = Registry(); reg.register("ff", 1, "pde"); reg.finalize()
    pen = Pencils(jnp.asarray(f[None], jnp.float32), grid, reg, cfg, None)
    zi = z[3:-3]
    d1 = np.asarray(pen.d("ff", 2)[0])[0, 0]
    np.testing.assert_allclose(d1, np.cos(zi), atol=2e-4)
    d2 = np.asarray(pen.d2("ff", 2)[0])[0, 0]
    np.testing.assert_allclose(d2, -np.sin(zi), atol=2e-3)


def test_high_order_convergence():
    """nghost=4/5 really widen the stencil: 8th/10th-order convergence on a
    sine wave (round-1 silently capped accuracy at 6th order — VERDICT).
    Checked in float64 with the same Fornberg weights the jitted ops use
    (f32 hits roundoff long before the high-order error floor)."""
    import numpy as np
    from pencil_tpu.ops import stencil as st

    errs = {}
    for g, order in ((3, 6), (4, 8), (5, 10)):
        err_by_n = []
        for n in (8, 16):
            x = (np.arange(-g, n + g) + 0.5) * (2 * np.pi / n)
            f = np.sin(x)
            w = np.asarray(st.fd_weights(st.central_offsets(g), 1))
            d = sum(w[k] * f[g + o: g + o + n]
                    for k, o in enumerate(st.central_offsets(g)))
            d = d / (2 * np.pi / n)
            err_by_n.append(np.abs(d - np.cos(x[g:-g])).max())
        rate = np.log2(err_by_n[0] / err_by_n[1])
        errs[g] = (err_by_n, rate)
        assert rate > order - 1.0, (g, order, rate, err_by_n)
    # higher order → smaller error at fixed n
    assert errs[4][0][0] < errs[3][0][0]
    assert errs[5][0][0] < errs[4][0][0]


def test_model_runs_at_10th_order():
    """A periodic MHD model at nghost=5 (10th order) steps stably and the
    registry/halo/pencil machinery honours the wider ghost zone."""
    import numpy as np
    from pencil_tpu import (Config, Density, EosIdealGas, GridSpec, Hydro,
                            Magnetic, Model, TimeSpec, Viscosity)
    cfg = Config(
        grid=GridSpec(nx=16, ny=16, nz=16, nghost=5),
        time=TimeSpec(itorder=3),
        modules=(EosIdealGas(gamma=1.0001),
                 Density(init="sinwave-z", ampl=0.05),
                 Hydro(init="gaussian-noise", ampl=1e-2),
                 Viscosity(ivisc=("nu-const",), nu=2e-3),
                 Magnetic(init="gaussian-noise", ampl=1e-3, eta=2e-3)),
    )
    model = Model(cfg)
    state = model.init_state(1)
    step = model.make_step()
    for _ in range(5):
        state = step(state)
    assert all(np.isfinite(np.asarray(v)).all()
               for v in state["fields"].values())
