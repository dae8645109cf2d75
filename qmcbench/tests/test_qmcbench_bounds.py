"""The yardstick's counts: kernel bounds and a walker-step's operations
against hand counts at a small shape, against the originals in
chip_smoke.py at the cells' shapes, and the readers that divide them by
traced time."""

import types

import numpy as np
import pytest

from qmcbench import bounds, harness

CONFIG = {"jastrow": {"ei_basis": [["polypade", 0.2, 7.5]], "ee_basis": [["cutoffcusp", 24.0, 7.5]]},
          "ecp": {"quadrature_points": 6}}
TINY = {"nelec": (1, 1), "symbols": ["H"], "ecp": {},
        "shells": [(0, 0, np.array([1.0]), np.array([1.0]))]}


def test_hand_counts_at_a_small_shape():
    s = bounds.Shapes(TINY, CONFIG)
    # one s shell of one primitive: 8 + 6 + 3 + 2 = 19 for the value, 11 more
    # with gradients, 8 per row to use it (n = 1)
    assert s.ao_ops(True, 8) == 38
    # electron-ion: (9 + 22 + 9); electron-electron: (9 + 20 + 9)
    assert s.jastrow_ops(True) == 78
    assert s.update_ops() == 8
    # a move: 11 + 2 (78 + 3) + 20 + 6 + 38 + 8 + 35 = 280, per electron and walker
    nbytes, ops = bounds.kernel_bounds(s, 10, {"vmc_sweep": 5})["vmc_sweep"]
    assert ops == 10 * 2 * 280 + 5 * 8
    # rows 21 in and out, 6 + 2 + 1 more per walker; 17 table words
    assert nbytes == 51 * 10 * 4 + 17 * 4
    # bytes bound it at this size
    assert bounds.bound_seconds(nbytes, ops) == pytest.approx(nbytes / bounds.HBM_BYTES_PER_S)


@pytest.fixture(scope="module")
def h2o():
    from pyqmc_tpu_torch.entry import h2o_setup
    from qmcbench.reference import molecule_sj

    cfg = harness.read_json(harness.repo_path("qmcbench/configs/h2o_sj.json"))
    shapes = bounds.Shapes(molecule_sj.load_system(harness.repo_path(cfg["data"])), cfg)
    return shapes, h2o_setup(4, device="cpu")


def test_molecule_counts_equal_the_originals(h2o):
    import chip_smoke

    shapes, (_, wf, _, _, acc) = h2o
    accepted = {"vmc_sweep": 1234, "dmc_sweep": 999, "tmove_sweep": 0}
    ours = bounds.kernel_bounds(shapes, 4096, accepted)
    theirs = chip_smoke.kernel_bounds(wf, acc["energy"].ecp_acc, 4096, accepted)
    for k in theirs:
        assert ours[k][1] == theirs[k][1]
        assert abs(ours[k][0] - theirs[k][0]) < 4096  # the constant tables differ by bytes


def test_crystal_counts_equal_the_originals():
    import chip_smoke
    from pyqmc_tpu_torch.entry import diamond_setup
    from qmcbench.systems import crystal_sj

    cfg = harness.read_json(harness.repo_path("qmcbench/configs/diamond_sj.json"))
    system = crystal_sj.System.__new__(crystal_sj.System)
    system.config, system.path = cfg, harness.repo_path(cfg["data"])
    shapes = system.shapes()
    assert shapes.nao == 489 and shapes.periodic
    _, wf, _, configs, _ = diamond_setup(2, device="cpu")
    theirs = chip_smoke.kernel_bounds_pbc(wf, configs.geometry, 2048,
                                          {"pbc_sweep": 7000, "pbc_dmc_sweep": 0}, 10000, 1)
    ours = bounds.pbc_kernel_bounds(shapes, 2048, {"vmc_sweep": 7000})
    assert ours["vmc_sweep"][1] == theirs["pbc_sweep"][1]
    assert ours["dmc_sweep"][1] == theirs["pbc_dmc_sweep"][1]
    assert bounds.value_mo_bound(shapes, 10000, 64)[1] == theirs["value_mo"][1]


class _Summary:
    def __init__(self, launches, seconds):
        self.launches, self.seconds = launches, seconds

    def kernel(self, patterns):
        return (self.launches, self.seconds) if "pq::tmove_sweep_kernel" in patterns else (0, 0.0)


def test_readers_divide_the_bound_by_traced_time(h2o):
    shapes, _ = h2o
    traffic = {"method": "dmc", "nconf": 1000}
    ctx = {"cell": types.SimpleNamespace(traffic=traffic), "shapes": shapes,
           "summary": _Summary(20, 0.5), "blocks": [{"acceptance": 0.9}, {"acceptance": 0.7}],
           "walker_steps": 20000, "window_s": 2.0, "steps": 20}
    nbytes, ops = bounds.kernel_bounds(shapes, 1000, {"tmove_sweep": 0.8 * 1000 * 8})["tmove_sweep"]
    expected = 100 * 20 * bounds.bound_seconds(nbytes, ops) / 0.5
    reader = harness.Cell("h2o_sj.dmc").metric_reader
    assert reader("tmove_roofline")(ctx) == pytest.approx(expected)
    assert reader("ecp_roofline")(ctx) is None  # no such kernel in the trace
    mfu = 100 * bounds.walker_step_flops(shapes, True, 0.8) * 20000 / 2.0 / bounds.FP32_FLOPS
    assert reader("step_mfu")(ctx) == pytest.approx(mfu)
