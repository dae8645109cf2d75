"""The reference against the program on the CPU in float64 at 8 walkers,
and a run of each cell with a fault planted under its timed path, which
the comparison has to call not correct."""

import time

import pytest
import torch

from qmcbench import faults, harness, run

SEED = 2**31 + 4321


CELLS = ["h2o_sj.vmc", "h2o_sj.dmc", "diamond_sj.vmc", "diamond_sj.dmc"]
# float64 gaps of a sound run: rounding; on the cell, the program's Ewald sums
# stop at 1e-10 where the reference's go on (about 2e-8 of the local energy)
EXACT = {"h2o_sj": 1e-10, "diamond_sj": 1e-6}


def tiny(name):
    cell = harness.Cell(name)
    n = 8 if cell.config["kind"] == "molecule_sj" else 4
    cell.traffic.update(nconf=n, sample=n, nsteps_per_block=2, trace_blocks=1)
    for k in ("equilibration_blocks", "warmup_vmc_blocks"):
        if k in cell.traffic:
            cell.traffic[k] = 1
    return cell


def execute(cell):
    return run.execute(cell, SEED, 0.5, 0, device="cpu", dtype=torch.float64,
                       t_start=time.perf_counter())[0]


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_program_in_float64(name):
    cell = tiny(name)
    result = execute(cell)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    tol = EXACT[cell.config["name"]]
    assert result["correct"] and result["failed"] == 0
    assert checks["walkers_apart"] == 0.0
    assert all(v < tol for k, v in checks.items() if k != "walkers_apart")


CASES = [(name, fault) for name in CELLS for fault in faults.FAULTS
         if name.endswith(".dmc") or fault != "comb_unchanged"]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny(name)
    with faults.planted(fault):
        result = execute(cell)
    assert not result["correct"]


def test_population_reductions_by_hand():
    """The float64 comb and block averages on numbers worked by hand."""
    from qmcbench.reference import population

    keep, mean = population.comb(torch.tensor([1.0, 1.0, 1.0, 1.0]), 0.5)
    assert keep.tolist() == [0, 1, 2, 3] and float(mean) == 1.0
    # running sums 3, 3.5, 3.75, 4; teeth at 0.25, 1.25, 2.25, 3.25
    keep, mean = population.comb(torch.tensor([3.0, 0.5, 0.25, 0.25]), 0.25)
    assert keep.tolist() == [0, 0, 0, 1] and float(mean) == 1.0
    energies = [{"total": torch.tensor([1.0, 3.0])}, {"total": torch.tensor([5.0, 7.0])}]
    assert population.vmc_averages(energies) == {"energytotal": 4.0}
    weights = [torch.tensor([1.0, 3.0]), torch.tensor([1.0, 1.0])]
    # step 1: (1 + 9) / 4 = 2.5; step 2: 6; mean 4.25; weights' mean 1.5
    assert population.dmc_averages(energies, weights) == {"energytotal": 4.25, "weight": 1.5}


def test_positions_that_are_not_finite_are_apart():
    """A walker the program left without positions (inf) or with NaN is
    apart, also through a cell's minimal image, which maps inf to NaN."""
    from qmcbench import checks

    R = torch.zeros(3, 2, 3, dtype=torch.float64)
    bad = R.clone()
    bad[1, 0, 0], bad[2, 1, 2] = float("inf"), float("nan")
    image = lambda d: d - 4.0 * torch.round(d / 4.0)
    for disp in (None, image):
        assert checks.apart(bad, R, disp).tolist() == [False, True, True]
