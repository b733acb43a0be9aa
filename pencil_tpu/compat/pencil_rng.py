"""Bit-exact re-implementation of the reference's machine-independent
random-number generators (``src/general.f90``): ``mars_ran`` /
``random_gen='nr_f90'`` (Park–Miller by Schrage combined with a Marsaglia
xorshift, per Numerical Recipes for F90) and ``ran0`` / ``'min_std'``.

Purpose: golden-test parity.  The reference's sample goldens
(reference.out) depend on the exact sequence of random draws — initial
gaussian noise (``src/initcond.f90`` gaunoise_vect), helical-forcing
wavevector/phase picks (``src/forcing.f90`` fconst_coefs_hel), particle
placement — so reproducing the generator + draw order lets this port
match time-series columns at format precision instead of order-of-magnitude
bands.

All arithmetic is 32-bit two's-complement integer (Fortran default
integer) and float32 (Fortran default real), reproduced here with masked
Python ints and np.float32.
"""
from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_IM = 2147483647
_IA = 16807
_IQ = 127773
_IR = 2836


def _s32(x):
    """Interpret a masked 32-bit pattern as a signed int."""
    x &= _M32
    return x - 0x100000000 if x & 0x80000000 else x


class MarsRan:
    """``mars_ran`` (random_gen='nr_f90', src/general.f90:625-676).

    State: rstate(1) Marsaglia xorshift (13, -17, 5), rstate(2)
    Park–Miller/Schrage.  ``seed_put`` replicates
    ``random_seed_wrapper(PUT=seed)``: put(2)==0 re-initializes via
    mars_ran(init=put(1)) (which consumes one draw), otherwise the state is
    restored verbatim.
    """

    def __init__(self, init: int = 1812):
        self._am = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0))
                              / np.float32(_IM))
        self.s1 = 0
        self.s2 = 0
        self._reinit(init)

    def _reinit(self, init1: int):
        self.s1 = (777755555 ^ abs(init1)) & _M32
        self.s2 = ((888889999 ^ abs(init1)) | 1) & _M32
        # Fortran: the initializing call falls through and returns a draw.

    def seed_put(self, seed):
        """random_seed_wrapper(PUT=...) semantics for nr_f90."""
        seed = list(seed)
        if len(seed) < 2 or seed[1] == 0:
            self._reinit(int(seed[0]))
            self.next()          # the init call consumes one draw
        else:
            self.s1 = int(seed[0]) & _M32
            self.s2 = int(seed[1]) & _M32

    def seed_get(self):
        return [_s32(self.s1), _s32(self.s2)]

    def next(self) -> np.float32:
        s1 = self.s1
        s1 ^= (s1 << 13) & _M32
        s1 &= _M32
        s1 ^= s1 >> 17
        s1 ^= (s1 << 5) & _M32
        s1 &= _M32
        self.s1 = s1
        s2 = _s32(self.s2)
        k = s2 // _IQ if s2 >= 0 else -((-s2) // _IQ)  # Fortran trunc division
        s2 = _IA * (s2 - k * _IQ) - _IR * k
        if s2 < 0:
            s2 += _IM
        self.s2 = s2 & _M32
        mixed = (_IM & (s1 ^ (s2 & _M32))) | 1
        return np.float32(self._am * np.float32(mixed))

    def draw(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        for i in range(n):
            out[i] = self.next()
        return out


class Ran0:
    """``ran0`` (random_gen='min_std', src/general.f90:601-623)."""

    _MASK = 123459876

    def __init__(self, seed: int = 1812):
        self.s = int(seed) & _M32

    def next(self) -> np.float32:
        d = _s32(self.s ^ self._MASK)
        k = d // _IQ if d >= 0 else -((-d) // _IQ)
        d = _IA * (d - k * _IQ) - _IR * k
        if d < 0:
            d += _IM
        out = np.float32(np.float32(1.0 / _IM) * np.float32(d))
        self.s = (d ^ self._MASK) & _M32
        return out

    def draw(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        for i in range(n):
            out[i] = self.next()
        return out


# ---------------------------------------------------------------------------
# Draw-order replications of reference consumers
# ---------------------------------------------------------------------------

def start_seed(seed0: int = 1812, iproc: int = 0) -> MarsRan:
    """State after start.x's seed PUT (src/start.f90:383-384):
    seed(1) = -((seed0-1812+1)*10 + iproc), seed(2:) = 0 → re-init + one
    consumed draw."""
    rng = MarsRan()
    rng.seed_put([-((seed0 - 1812 + 1) * 10 + iproc), 0])
    return rng


def gaunoise_vect(rng, ampl: float, mx: int, my: int, mz: int,
                  ncomp: int) -> np.ndarray:
    """Reference gaunoise_vect (src/initcond.f90:4351-4389): per (n, m)
    plane-line and component, Gaussian noise over the full ghosted x-line;
    even components draw fresh (r, p) and use sin, odd components reuse the
    previous (r, p) with cos.  Returns (ncomp, mx, my, mz) float32 (the
    *added* noise; caller adds to f)."""
    out = np.empty((ncomp, mx, my, mz), np.float32)
    two_pi = np.float32(2.0) * np.float32(np.pi)
    a = np.float32(ampl)
    for n in range(mz):
        for m in range(my):
            r = p = None
            for i in range(ncomp):
                if i % 2 == 0:
                    r = rng.draw(mx)
                    p = rng.draw(mx)
                    tmp = np.sqrt(np.float32(-2.0) * np.log(r)) * np.sin(two_pi * p)
                else:
                    tmp = np.sqrt(np.float32(-2.0) * np.log(r)) * np.cos(two_pi * p)
                out[i, :, m, n] = a * tmp.astype(np.float32)
    return out


def forcing_hel_sequence(rng, nsteps: int, kkx, kky, kkz):
    """Per-step helical-forcing draws (src/forcing.f90 fconst_coefs_hel
    :1578-1700, default flags: no lavoid_*, old_forcing_evector=F):
    fran(2) → phase = π(2·fran1 − 1), ik = int(nk·0.9999·fran2) + 1;
    then phi → rotation of the polarization vector.

    Returns (kk[nsteps, 3], phase[nsteps], phi[nsteps]) float32/float64.
    """
    nk = len(kkx)
    kk = np.empty((nsteps, 3), np.float64)
    phase = np.empty(nsteps, np.float64)
    phi = np.empty(nsteps, np.float64)
    pi32 = np.float32(np.pi)
    for i in range(nsteps):
        f1 = rng.next()
        f2 = rng.next()
        # all arithmetic in f32, as in a single-precision reference build
        phase[i] = pi32 * (np.float32(2.0) * f1 - np.float32(1.0))
        ik = int(np.float32(nk) * (np.float32(0.9999) * f2)) + 1  # 1-based
        kk[i] = (kkx[ik - 1], kky[ik - 1], kkz[ik - 1])
        phi[i] = rng.next() * np.float32(2.0) * pi32
    return kk, phase, phi


def read_k_dat(path):
    """Read the reference's k.dat wavevector-shell file (first line:
    nk, kav; then kkx, kky, kkz lists)."""
    with open(path) as fh:
        tok = fh.read().split()
    nk = int(tok[0])
    kav = float(tok[1])
    vals = [float(t) for t in tok[2:2 + 3 * nk]]
    kkx = np.asarray(vals[:nk])
    kky = np.asarray(vals[nk:2 * nk])
    kkz = np.asarray(vals[2 * nk:3 * nk])
    return nk, kav, kkx, kky, kkz
