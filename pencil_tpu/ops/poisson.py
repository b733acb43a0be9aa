"""FFT-based Poisson solver (reference ``src/poisson.f90``
``inverse_laplacian_fft`` :85-253 over ``src/fourier_fftpack.f90``'s
transpose-based parallel FFT).

JAX-native: ``jnp.fft`` on the (possibly sharded) global array — under jit
with sharded inputs XLA inserts the all-to-all transposes that the
reference hand-codes in ``transp`` (src/mpicomm.f90:5298).  Solves
∇²φ = f in a fully periodic box; the k=0 mode is projected out (φ defined
up to a constant; f must have zero mean for solvability)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def wavenumbers(spec, dtype=jnp.float32):
    kx = 2 * np.pi * np.fft.fftfreq(spec.nx, d=spec.Lx / spec.nx)
    ky = 2 * np.pi * np.fft.fftfreq(spec.ny, d=spec.Ly / spec.ny)
    kz = 2 * np.pi * np.fft.fftfreq(spec.nz, d=spec.Lz / spec.nz)
    return (jnp.asarray(kx, dtype), jnp.asarray(ky, dtype),
            jnp.asarray(kz, dtype))


def diffuse_fft(f, spec, coeff, dt):
    """Exact spectral integration of ∂F/∂t = D∇²F over one step:
    F̂ ← F̂·exp(−D k² dt) (reference implicit_diffusion.f90:163
    integrate_diffusion_fft, implicit_method='fft').  ``f`` is the
    interior field, trailing axes (nx, ny, nz), periodic box."""
    kx, ky, kz = wavenumbers(spec, jnp.float32)
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    decay = jnp.exp(-coeff * dt * k2)
    fk = jnp.fft.fftn(f, axes=(-3, -2, -1)) * decay
    return jnp.real(jnp.fft.ifftn(fk, axes=(-3, -2, -1))).astype(f.dtype)


def inverse_laplacian(f, spec):
    """φ with ∇²φ = f (periodic box, spectral inverse)."""
    kx, ky, kz = wavenumbers(spec, jnp.float32)
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    fk = jnp.fft.fftn(f, axes=(-3, -2, -1))
    inv = jnp.where(k2 > 0, -1.0 / jnp.maximum(k2, 1e-30), 0.0)
    phik = fk * inv
    return jnp.real(jnp.fft.ifftn(phik, axes=(-3, -2, -1))).astype(f.dtype)


def inverse_laplacian_sharded(f_local, spec, mesh_axis_names=None,
                              mesh_shape=(1, 1, 1)):
    """Global periodic Poisson solve from inside a ``shard_map`` region.

    The reference's solve is global by construction (src/poisson.f90:85
    over ``transp``-rotated full pencils, src/mpicomm.f90:5298); a local
    per-shard FFT would silently solve nproc independent small problems.
    Here each shard ``all_gather``s the source to the full grid, solves
    spectrally, and slices its own block back out — O(N) replicated memory
    per device, which is fine at the grid sizes a Poisson-gravity run uses;
    an all_to_all transposed FFT is the scalable upgrade path.
    """
    names = mesh_axis_names or (None, None, None)
    full = f_local
    for axis in range(3):
        if names[axis] is not None and mesh_shape[axis] > 1:
            full = jax.lax.all_gather(full, names[axis], axis=axis,
                                      tiled=True)
    phi = inverse_laplacian(full, spec)
    for axis in range(3):
        if names[axis] is not None and mesh_shape[axis] > 1:
            n_loc = phi.shape[axis] // mesh_shape[axis]
            idx = jax.lax.axis_index(names[axis])
            phi = jax.lax.dynamic_slice_in_dim(phi, idx * n_loc, n_loc,
                                               axis=axis)
    return phi


def inverse_laplacian_z(f, spec, dz):
    """∇²φ = f with periodic x,y and a non-periodic z direction — the
    Boussinesq projection solver (reference
    src/experimental/boussinesq.f90:438-541 ``inverse_laplacian_z``):
    FFT in x,y; per-mode 4th-order pentadiagonal solve in z with the
    reference's mirrored end-row coefficients; the (kx,ky)=0 mode by the
    1-D Green's function φ(z) = ∫ ½|z−z'| f(z') dz' (trapezoid weights).

    f: (nx, ny, nz) interior field.  Returns φ of the same shape.
    """
    nx, ny, nz = f.shape
    kx = 2 * np.pi * np.fft.fftfreq(spec.nx, d=spec.Lx / spec.nx)
    ky = 2 * np.pi * np.fft.fftfreq(spec.ny, d=spec.Ly / spec.ny) \
        if spec.ny > 1 else np.zeros(1)
    k2 = (kx[:, None] ** 2 + ky[None, :] ** 2).reshape(-1)   # (nx*ny,)
    dz_2 = 1.0 / (dz * dz)

    # pentadiagonal operator rows (boussinesq.f90:495-510): interior
    # [-1/12, 4/3, -5/2, 4/3, -1/12]·dz⁻² − k²δ, with the reference's
    # doubled off-diagonals at the ends (Neumann mirror closure)
    P = np.zeros((nz, nz))
    for i in range(nz):
        for off, c in ((-2, -dz_2 / 12.0), (-1, 4.0 * dz_2 / 3.0),
                       (0, -2.5 * dz_2), (1, 4.0 * dz_2 / 3.0),
                       (2, -dz_2 / 12.0)):
            j = i + off
            if 0 <= j < nz:
                P[i, j] = c
    # end-row doublings exactly as the reference tables them:
    # d(1)·2, e(1)·2, e(2)·2, a(n)·2, b(n)·2, a(n−1)·2
    P[0, 1] *= 2.0
    if nz > 2:
        P[0, 2] *= 2.0
    if nz > 3:
        P[1, 3] *= 2.0
        P[nz - 1, nz - 3] *= 2.0
        P[nz - 2, nz - 4] *= 2.0
    P[nz - 1, nz - 2] *= 2.0

    # batched dense solve: A_k = P − k² I (nz ≤ O(100): cheap, compiled once)
    A = jnp.asarray(P)[None] - k2[:, None, None] * jnp.eye(nz)[None]
    fk = jnp.fft.fft2(f.astype(jnp.float32), axes=(0, 1)).reshape(-1, nz)
    sol = jnp.linalg.solve(A.astype(jnp.complex64), fk[:, :, None])[..., 0]

    # (0,0) mode: Green's function quadrature (boussinesq.f90:515-526)
    w = np.ones(nz)
    w[0] = w[-1] = 0.5
    iz = np.arange(nz)
    K = 0.5 * dz * dz * np.abs(iz[:, None] - iz[None, :]) * w[None, :]
    sol0 = jnp.asarray(K, jnp.float32) @ fk[0]
    sol = sol.at[0].set(sol0)

    phik = sol.reshape(nx, ny, nz)
    return jnp.real(jnp.fft.ifft2(phik, axes=(0, 1))).astype(f.dtype)
