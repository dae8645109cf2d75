"""Flat public API (counterpart of pyqmc_tpu/api.py).

    from pyqmc_tpu_torch.api import Molecule, run_scf, OPTIMIZE, VMC, DMC
"""

from .system.mole import Molecule, Cell
from .system.scf import run_scf, MeanField
from .system.supercell import get_supercell, get_supercell_kpts, create_supercell_twists
from .configs import Configs, Geometry, initial_guess
from .models.slater import Slater, DeterminantExpansion
from .models.jastrow import JastrowSpin
from .models.jastrow3 import ThreeBodyJastrow
from .models.multiply import MultiplyWF
from .models.orbitals import MolecularOrbitals, KPointOrbitals
# EmbeddedKSlater and PairKSlater, the TPU's real-pair stand-ins for complex ops, are not
# ported on purpose (ROADMAP queue 1 item 7): the port's complex path is native.
from .method.twist_average import twist_average_vmc, build_twist_wf
from .observables.accumulators import EnergyAccumulator, gradient_generator
from .observables.ecp import ECPAccumulator
from .observables.ewald import Ewald
from .observables.obdm import OBDMAccumulator, KOBDMAccumulator
from .observables.tbdm import TBDMAccumulator, KTBDMAccumulator
from .observables.s2 import S2Accumulator
from .observables.sq import SqAccumulator
from .observables.symmetry import SymmetryAccumulator
from .observables.transform import LinearTransform
from .observables.sr import StochasticReconfiguration
from .method.vmc import vmc
from .method.dmc import rundmc
from .method.linemin import line_minimization
from .method.sample_many import sample_overlap
from .method.ensemble import optimize_ensemble
from .method.optvariance import optvariance
from .method.extrapolate import tstep_extrapolate
from .models.addwf import AddWF
from .models.generic_jastrow import GeminalJastrow, GPSJastrow
from .system.casci import run_casci, run_hci
from .system.ci_import import (
    interpret_ci,
    expansion_from_determinants,
    determinants_from_bitstrings,
)
from .system.io import save_system, load_system
from .wftools import (
    generate_wf,
    generate_slater,
    generate_jastrow,
    generate_jastrow3,
    generate_gps_jastrow,
    generate_geminal_jastrow,
    read_superposition,
    save_wf_params,
    read_wf_params,
)
from .recipes import OPTIMIZE, VMC, DMC, read_mc_output, read_opt
from .reblock import reblock, reblock_by2, opt_block, reblock_summary
