"""Snapshots & bit-exact restart.

Reference contract (``src/snapshot.f90`` wsnap/rsnap :222-319, ``io_dist``
one-file-per-rank var.dat, and ``src/persist.f90`` tagged persistent records
— RNG seeds, forcing phase, shear offset — record ids in
``src/record_types.h``): a checkpoint must restore the run *bit-exactly*.

JAX-native realization: a single .npz per snapshot holding every state
field, t/dt/it, and the JAX PRNG key (the persist-record equivalent — all
stochastic state lives in the key).  Device sharding is reconstructed on
load by the caller; arrays are stored gathered.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np


def save_snapshot(path, state: Dict, extra: Optional[Dict] = None):
    arrays = {f"field_{k}": np.asarray(v) for k, v in state["fields"].items()}
    for k, v in state.get("particles", {}).items():
        arrays[f"par_{k}"] = np.asarray(v)
    arrays["t"] = np.asarray(state["t"])
    arrays["dt"] = np.asarray(state["dt"])
    arrays["it"] = np.asarray(state["it"])
    arrays["key"] = np.asarray(jax.random.key_data(state["key"])) \
        if jnp.issubdtype(state["key"].dtype, jax.dtypes.prng_key) \
        else np.asarray(state["key"])
    if extra:
        arrays["extra_json"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    tmp = str(path) + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never corrupts var.dat


def load_snapshot(path) -> Dict:
    with np.load(path) as z:
        fields = {}
        particles = {}
        key = None
        extra = None
        for k in z.files:
            if k.startswith("field_"):
                fields[k[6:]] = jnp.asarray(z[k])
            elif k.startswith("par_"):
                particles[k[4:]] = jnp.asarray(z[k])
            elif k == "key":
                raw = z[k]
                if raw.dtype == np.uint32 and raw.shape == (2,):
                    key = jax.random.wrap_key_data(raw)
                else:
                    key = jnp.asarray(raw)
            elif k == "extra_json":
                extra = json.loads(bytes(z[k].tobytes()).decode())
        state = {
            "fields": fields,
            "t": jnp.asarray(z["t"]),
            "dt": jnp.asarray(z["dt"]),
            "it": jnp.asarray(z["it"]),
            "key": key,
        }
        if particles:
            state["particles"] = particles
    if extra is not None:
        state["extra"] = extra
    return state
