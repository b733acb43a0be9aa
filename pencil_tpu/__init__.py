"""pencil_tpu — JAX-native high-order finite-difference MHD framework.

A from-scratch JAX/XLA re-design of the Pencil Code's capability set
(compressible MHD + coupled astrophysical PDEs + Lagrangian particles on
high-order central finite differences with RK3-2N time stepping).  See
SURVEY.md at the repository root for the structural map of the reference
and docs/ for the design of this framework.
"""
from .core.config import Config, GridSpec, MeshSpec, TimeSpec
from .core.grid import make_grid
from .model import Model
from .ops.boundary import BC

__version__ = "0.1.0"
from .physics import (Density, Entropy, EosIdealGas, Forcing, Gravity,
                      Hydro, Magnetic, Viscosity)
from .physics import Shock
from .physics import PassiveScalar, Shear
from .physics import SelfGravity
from .particles import ParticlesDust
from .particles.drag import ParticlesDrag
from .particles.collisions import ParticlesCollisions
from .physics import HydroKinematic, RadiationRay, TemperatureIdealGas
from .physics import TestfieldZ
from .physics import TestflowZ
from .physics import BorderProfiles, CosmicRay
from .physics import DustFluid, Neutrals
from .physics import Chemistry
from .physics import (ActiveScalar, Chiral, HeatFlux, Interstellar, LorenzGauge, Polymer)
from .physics import EosIonization
from .physics import InitialCondition
