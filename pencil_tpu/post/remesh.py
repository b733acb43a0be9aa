"""Offline regridding (reference ``remesh/`` tool: change resolution and/or
processor layout between runs — SURVEY.md §2.12).

JAX-native: resolution change by spectral resampling in periodic
directions (exact for resolved modes) and linear interpolation in
non-periodic ones; the "processor layout" half of the reference tool is
moot — snapshots are a single logical array and re-sharding happens at
load time via the device mesh."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _spectral_resample_axis(f, n_new, axis):
    n_old = f.shape[axis]
    if n_new == n_old:
        return f
    fk = np.fft.rfft(np.asarray(f), axis=axis)
    n_keep = min(n_old, n_new) // 2 + 1
    shape = list(f.shape)
    shape[axis] = n_new // 2 + 1
    gk = np.zeros(shape, fk.dtype)
    sl_src = [slice(None)] * f.ndim
    sl_dst = [slice(None)] * f.ndim
    sl_src[axis] = slice(0, n_keep)
    sl_dst[axis] = slice(0, n_keep)
    gk[tuple(sl_dst)] = fk[tuple(sl_src)]
    out = np.fft.irfft(gk, n=n_new, axis=axis) * (n_new / n_old)
    return out.astype(np.asarray(f).dtype)


def _linear_resample_axis(f, n_new, axis):
    n_old = f.shape[axis]
    if n_new == n_old:
        return f
    f = np.asarray(f)
    x_old = np.linspace(0.0, 1.0, n_old)
    x_new = np.linspace(0.0, 1.0, n_new)
    f_moved = np.moveaxis(f, axis, -1)
    out = np.empty(f_moved.shape[:-1] + (n_new,), f.dtype)
    flat = f_moved.reshape(-1, n_old)
    oflat = out.reshape(-1, n_new)
    for i in range(flat.shape[0]):
        oflat[i] = np.interp(x_new, x_old, flat[i])
    return np.moveaxis(out, -1, axis)


def remesh_state(state, old_spec, new_spec):
    """Resample every field of a state dict onto a new GridSpec."""
    out_fields = {}
    for name, arr in state["fields"].items():
        a = np.asarray(arr)
        sp = a.ndim - 3
        for axis, (n_new, per) in enumerate(
                zip(new_spec.shape, new_spec.periodic)):
            ax = sp + axis
            if per:
                a = _spectral_resample_axis(a, n_new, ax)
            else:
                a = _linear_resample_axis(a, n_new, ax)
        out_fields[name] = jnp.asarray(a)
    out = dict(state)
    out["fields"] = out_fields
    return out
