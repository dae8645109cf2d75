"""The port's constructors take their arguments in the JAX package's order,
so that the reference's own positional calls build the same objects:

- Slater(mol, orbitals, expansion, mo_coeff=None, det_coeff=None)
  (pyqmc_tpu/models/slater.py), as wftools and twist_average call it;
- ECPAccumulator(mol, naip=None, rmax=10.0, nselect, echunk, fused)
  (pyqmc_tpu/observables/ecp.py): ECPAccumulator(mol, 6) asks for six
  quadrature points per atom and leaves rmax at 10 bohr;
- the front door (Molecule, Cell, run_scf, run_casci, run_hci,
  generate_slater, OPTIMIZE, VMC, DMC, generate_accumulators) takes the
  JAX package's parameters, the port adding only `device` (and `dtype`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
from pyqmc_tpu.models.slater import Slater as JSlater
from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP

from pyqmc_tpu_torch.convert import params_from_numpy
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator

from .torch_parity import F64, compile_quick, diamond_cells, h2o_pair, kpoint_orbitals, walkers


def test_slater_takes_the_reference_order():
    """The reference's positional calls, molecular and periodic; the
    molecular determinant's value against the JAX package's on shared
    walkers."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    nup, ndn = tmol.nelec
    ca, cb = tmf.mo_coeff[0][:, :nup], tmf.mo_coeff[1][:, :ndn]
    twf = Slater(tmol, None, DeterminantExpansion.single(nup, ndn), (ca, cb))
    jwf = JSlater(jmol, None, JExpansion.single(nup, ndn), (ca, cb))
    assert twf.orbitals.norb == (nup, ndn)
    pos = walkers(np.random.default_rng(3), 4)
    jparams = jwf.make_params()
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
                                dtype=F64)
    tphase, tlog = twf.value(tparams, twf.recompute(tparams, torch.as_tensor(pos, dtype=F64)))
    jvalue = jax.jit(lambda p, x: jwf.value(p, jwf.recompute(p, x)))
    jpos = jnp.asarray(pos)
    jphase, jlog = compile_quick(jvalue, jparams, jpos)(jparams, jpos)
    np.testing.assert_allclose(tphase.numpy(), np.asarray(jphase), atol=1e-12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-10)

    _, _, tcell = diamond_cells()
    _, torb = kpoint_orbitals(1)
    cwf = Slater(tcell, torb, DeterminantExpansion.single(4, 4))
    assert cwf.orbitals is torb and (cwf.nup, cwf.ndn) == (4, 4)
    with pytest.raises(ValueError):
        Slater(tmol, None, DeterminantExpansion.single(3, 4), (ca, cb))


def test_ecp_accumulator_takes_the_reference_order():
    """naip, second as in the reference, sets every atom's grid; rmax stays
    at its default; a grid the port has not got raises."""
    (jmol, _), (tmol, _) = h2o_pair()
    default = ECPAccumulator(tmol)
    assert default.atom_naip == JECP(jmol).atom_naip == [6]
    for acc, jacc in ((ECPAccumulator(tmol, 6), JECP(jmol, 6)),
                      (ECPAccumulator(tmol, naip=12), JECP(jmol, naip=12))):
        assert acc.rmax == 10.0 == jacc.rmax
        assert acc.atom_naip == jacc.atom_naip and acc.naip == jacc.naip
        assert acc.nq_total == sum(jacc.atom_naip)
    assert ECPAccumulator(tmol, naip=12).nq_total == 12
    assert ECPAccumulator(tmol, None, 6.0).rmax == 6.0
    with pytest.raises(ValueError):
        ECPAccumulator(tmol, 7)


def _front_door_pairs():
    from pyqmc_tpu import recipes as jrecipes
    from pyqmc_tpu import wftools as jwftools
    from pyqmc_tpu.system import casci as jcasci
    from pyqmc_tpu.system import mole as jmole
    from pyqmc_tpu.system import scf as jscf

    from pyqmc_tpu_torch import recipes, wftools
    from pyqmc_tpu_torch.system import casci, mole, scf

    return {"Molecule": (mole.Molecule, jmole.Molecule), "Cell": (mole.Cell, jmole.Cell),
            "run_scf": (scf.run_scf, jscf.run_scf),
            "run_casci": (casci.run_casci, jcasci.run_casci),
            "run_hci": (casci.run_hci, jcasci.run_hci),
            "generate_slater": (wftools.generate_slater, jwftools.generate_slater),
            "OPTIMIZE": (recipes.OPTIMIZE, jrecipes.OPTIMIZE),
            "VMC": (recipes.VMC, jrecipes.VMC), "DMC": (recipes.DMC, jrecipes.DMC),
            "generate_accumulators": (recipes.generate_accumulators,
                                      jrecipes.generate_accumulators)}


@pytest.mark.parametrize("name", ["Molecule", "Cell", "run_scf", "run_casci", "run_hci",
                                  "generate_slater", "OPTIMIZE", "VMC", "DMC",
                                  "generate_accumulators"])
def test_front_door_takes_the_reference_signature(name):
    """The front door's parameters are the JAX package's, in its order,
    with its defaults and kinds; the port adds at most `device` (and
    `dtype`), defaulting to None, after them and before a **kwargs."""
    import inspect

    port, ref = _front_door_pairs()[name]
    tp = list(inspect.signature(port).parameters.values())
    jp = list(inspect.signature(ref).parameters.values())
    jfixed = [p for p in jp if p.kind != p.VAR_KEYWORD]
    assert [(p.name, p.kind, p.default) for p in tp[:len(jfixed)]] == [
        (p.name, p.kind, p.default) for p in jfixed]
    rest = tp[len(jfixed):]
    extra = [p for p in rest if p.kind != p.VAR_KEYWORD]
    assert all(p.name in ("device", "dtype") and p.default is None for p in extra)
    assert [p.name for p in rest if p.kind == p.VAR_KEYWORD] == [
        p.name for p in jp if p.kind == p.VAR_KEYWORD]
