"""Static configuration objects.

The reference framework freezes grid size, processor layout and module
selection at *compile time* (``src/cparam.local`` + ``src/Makefile.local``,
see reference ``src/cparam.f90:19-80``).  The JAX analog is a frozen,
hashable dataclass passed as a static argument to ``jax.jit`` — XLA then
specializes the compiled step exactly like the Fortran build specialized the
binary, with none of the codegen machinery.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class GridSpec:
    """Compile-time grid geometry (reference ``src/cparam.f90:19-80``).

    Dimensions are *global*; per-shard sizes are derived from the mesh.
    Axis order everywhere in this package is (x, y, z) with z the minor
    (contiguous) axis of the underlying arrays.
    """

    nx: int = 32
    ny: int = 32
    nz: int = 32
    x0: float = -math.pi
    y0: float = -math.pi
    z0: float = -math.pi
    Lx: float = TWO_PI
    Ly: float = TWO_PI
    Lz: float = TWO_PI
    periodic: Tuple[bool, bool, bool] = (True, True, True)
    nghost: int = 3
    coords: str = "cartesian"  # 'cartesian' | 'cylindrical' | 'spherical'
    # Non-equidistant grid functions per axis ('uniform'|'sinh'|'tanh'...),
    # mirroring reference src/grid.f90 grid_func.
    grid_func: Tuple[str, str, str] = ("uniform", "uniform", "uniform")
    grid_coeff: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # clustering location per axis for 'sinh'-type functions (reference
    # xyz_star, cdata.f90:130 default 0; grid.f90:211 find_star)
    xyz_star: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # per-axis 'step-linear' parameters (grid.f90:262,579,737):
    # (xyz_step1, xyz_step2, xi_step_frac1, xi_step_frac2, width1, width2)
    # in the reference's namelist layout; () = unused axis
    grid_step: Tuple[tuple, tuple, tuple] = ((), (), ())
    # shift coordinates by +Δ/2 per axis (reference lshift_origin): cell
    # centres instead of cell edges
    lshift_origin: Tuple[bool, bool, bool] = (False, False, False)
    # pole axes (reference lpole, grid.f90:126,151): periodic-style
    # spacing + half-cell shift so no node sits ON the θ pole, while the
    # physical BCs stay non-periodic ('pp'/'ap' across-pole)
    lpole: Tuple[bool, bool, bool] = (False, False, False)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def mx(self) -> int:
        return self.nx + 2 * self.nghost

    @property
    def my(self) -> int:
        return self.ny + 2 * self.nghost

    @property
    def mz(self) -> int:
        return self.nz + 2 * self.nghost

    @property
    def dx(self) -> float:
        """Uniform spacing; periodic axes exclude the duplicate endpoint."""
        return self.Lx / self.nx if self.periodic[0] else self.Lx / max(self.nx - 1, 1)

    @property
    def dy(self) -> float:
        if self.periodic[1] or self.lpole[1]:
            return self.Ly / self.ny
        return self.Ly / max(self.ny - 1, 1)

    @property
    def dz(self) -> float:
        return self.Lz / self.nz if self.periodic[2] else self.Lz / max(self.nz - 1, 1)

    def axis_n(self, axis: int) -> int:
        return (self.nx, self.ny, self.nz)[axis]


@dataclass(frozen=True)
class MeshSpec:
    """Device-mesh layout: the analog of the reference's static
    nprocx × nprocy × nprocz decomposition (``src/cparam.f90:19``), realized
    as a ``jax.sharding.Mesh`` with axes ('x','y','z')."""

    px: int = 1
    py: int = 1
    pz: int = 1

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.px, self.py, self.pz)

    @property
    def ndev(self) -> int:
        return self.px * self.py * self.pz


@dataclass(frozen=True)
class TimeSpec:
    """Time-integration parameters (reference ``src/timestep.f90:19-66``,
    CFL coefficients ``src/cdata.f90:145-149``)."""

    itorder: int = 3           # RK order: 1, 2, 3 (2N low-storage);
                               # 5 = adaptive Cash-Karp RKF45
    cdt: float = 0.9           # advective CFL safety factor
    cdtv: float = 0.25         # diffusive (del2) CFL
    cdtv3: float = 0.01        # hyperdiffusive (del6) CFL (cdata.f90:149)
    cdts: float = 1.0          # heating/cooling-rate safety (cdata:145)
    dt: float = 0.0            # fixed dt if > 0, else adaptive
    dtmin: float = 1.0e-10
    dtmax: float = 1.0e37
    ddt: float = 0.0           # max dt growth ratio per step (0 = off)
    eps_rkf: float = 1.0e-8    # RKF45 error tolerance (cdata eps_rkf)
    tstart: float = 0.0        # initial time (init_pars tstart)


@dataclass(frozen=True)
class Config:
    """Top-level static simulation configuration.

    ``modules`` is the tuple of physics-module configs (each itself a frozen
    dataclass) — the analog of one-implementation-per-slot selection in
    ``src/Makefile.src:11-138``; an absent module is simply not in the tuple
    (no 'nomodule' stubs needed in a functional composition).
    """

    grid: GridSpec = field(default_factory=GridSpec)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    time: TimeSpec = field(default_factory=TimeSpec)
    modules: tuple = ()
    dtype: str = "float32"
    # Boundary conditions per axis: tuples of per-field mnemonic strings,
    # keyed by field name; empty = periodic everywhere (see ops/boundary.py).
    bcx: tuple = ()
    bcy: tuple = ()
    bcz: tuple = ()
    # 'g' (forced-boundary) profiles for the lower/upper z boundary
    # (reference &run_pars force_lower_bound/force_upper_bound)
    force_bound: tuple = ("", "")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def module(self, name: str):
        for m in self.modules:
            if m.name == name:
                return m
        return None

    def has(self, name: str) -> bool:
        return self.module(name) is not None
