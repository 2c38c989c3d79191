"""lightweaver_tpu: a JAX-native NLTE radiative transfer framework.

A from-scratch JAX/XLA re-design with the capabilities of the
Lightweaver framework (Osborne & Milic 2021): MALI NLTE synthesis for
optically-thick spectral lines in stratified atmospheres, batched and
sharded across device meshes (NVIDIA GPUs).

Like the reference (f64 throughout), the default working precision is
float64: MALI's Psi*-preconditioning subtracts nearly-equal large
quantities (Ieff = I - Psi eta) in optically-thick regions, which makes
plain f32 stall around dJ ~ 1e-2.  x64 is enabled at import (disable
with LIGHTWEAVER_TPU_NO_X64=1 to run pure-f32 experiments).  An f32
state (dtype=jnp.float32, f64 accumulation) is kept for synthesis-only
workloads.
"""
import os as _os

import jax as _jax

if not _os.environ.get('LIGHTWEAVER_TPU_NO_X64'):
    _jax.config.update('jax_enable_x64', True)

from . import constants
from .ops.faddeeva import voigt_H, voigt_HF, wofz
from .ops.planck import planck_nu

__version__ = '0.1.0'

# user-facing API surface (mirrors the reference's package exports)
from .atmosphere import (Atmosphere, BoundaryCondition, Layout, NoBc,
                         PeriodicRadiation, ScaleType, Stratifications,
                         ThermalisedRadiation, ZeroRadiation)
from .atomic_model import (AtomicLevel, AtomicLine, AtomicModel,
                           ExplicitContinuum, HydrogenicContinuum,
                           LinearCoreExpWings, LinearQuadrature,
                           LineProfileResult, LineProfileState, LineType,
                           TabulatedQuadrature, VoigtLine, gaunt_bf,
                           reconfigure_atom)
from .atomic_set import (RadiativeSet, SpectrumConfiguration, hminus_pops,
                         lte_pops)
from .benchmark import benchmark
from .molecule import MolecularTable
from .multi import read_multi_atmos
from .atomic_table import (AtomicAbundance, DefaultAtomicAbundance, Element,
                           Isotope, KuruczPfTable, PeriodicTable)
from .config import params as configParams
from .config import params as ConfigDict
from .context import Context
from .fal import Falc82
from .iterate_ctx import (ConvergenceCriteria, DefaultConvergenceCriteria,
                          iterate_ctx_se)
from .iteration_update import IterationUpdate
from .ops.ng import NgOptions
from .utils import (ConvergenceError, CrswIterator, ExplodingMatrixError,
                    InitialSolution, UnityCrswIterator, air_to_vac,
                    compute_contribution_fn, compute_height_edges,
                    compute_radiative_losses, compute_wavelength_edges,
                    convert_specific_intensity, get_data_path,
                    get_default_molecule_path, integrate_line_losses, planck,
                    vac_to_air)

# the reference exposes nr_post_update as a free function monkeypatched
# onto Context (ref: /root/reference/lightweaver/__init__.py:28-33);
# here it is a real method, re-exported for drop-in compatibility
nr_post_update = Context.nr_post_update
