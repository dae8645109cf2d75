"""The harness: cells found from files by name, the window's arithmetic on
a fake clock, and the import check on modules' top-level names."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from qmcbench import harness, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_cell_and_metric_taken_up_from_added_files(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files are found by the names an entry gives them."""
    pkg = tmp_path / "qmcbench"
    _write(str(pkg / "configs" / "new_sys.json"), json.dumps({"kind": "molecule_sj", "n": 3}))
    _write(str(pkg / "traffic" / "mix.json"), json.dumps({"method": "vmc", "nconf": 64}))
    _write(str(pkg / "limits" / "new_sys.mix.json"), json.dumps({"energy_gap": 0.5}))
    _write(str(pkg / "metrics" / "new_metric.py"),
           "def read(ctx):\n    return 2.0 * ctx['x'] if ctx['x'] else None\n")
    bench = {
        "configs": [{"name": "new_sys", "file": str(pkg / "configs" / "new_sys.json")}],
        "workloads": [{"name": "new_sys.mix", "config": "new_sys", "traffic": "mix",
                       "chips": 1}],
        "end_to_end": [{"name": "walker_steps_per_s", "unit": "walker-steps/s"}],
        "per_layer": [{"name": "new_metric", "unit": "%", "workloads": ["new_sys.mix"]},
                      {"name": "elsewhere", "unit": "%", "workloads": ["other.cell"]}],
    }
    cell = harness.Cell("new_sys.mix", bench=bench, package=str(pkg))
    assert cell.config == {"kind": "molecule_sj", "n": 3}
    assert cell.traffic["nconf"] == 64 and cell.limits == {"energy_gap": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert [m["name"] for m in cell.end_to_end] == ["walker_steps_per_s"]
    assert cell.metric_reader("new_metric")({"x": 1.5}) == 3.0
    assert cell.metric_reader("new_metric")({"x": 0}) is None
    assert cell.system_module().__name__ == "qmcbench.systems.molecule_sj"
    assert cell.method_module().__name__ == "qmcbench.methods.vmc"
    with pytest.raises(harness.MissingFile):
        harness.Cell("absent.cell", bench=bench, package=str(pkg))


def test_committed_cells_have_their_files():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench=bench)
        assert cell.limits and cell.per_layer and len(cell.end_to_end) == 2
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]))


@pytest.mark.parametrize("seconds,t_block,expected", [(10, 1.3, 7), (10, 10.0, 1), (10, 25.0, 1),
                                                      (30, 2.9, 10)])
def test_blocks_in_window(seconds, t_block, expected):
    assert run.blocks_in_window(seconds, t_block) == expected


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_on_a_fake_clock(monkeypatch):
    """setup_s runs from the start to the window; the rate is every block's
    walker-steps over the window's seconds; a block with a non-finite
    average counts as failed."""
    clock = _Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)

    class Run:
        def __init__(self, system, traffic, seed):
            self.traffic = traffic

        def setup(self):
            clock.t += 7.0  # equilibration ...
            clock.t += 2.5  # ... and one warm block
            return 2.5

        def window(self, nblocks):
            clock.t += 2.5 * nblocks
            return [{"energytotal": -17.0 if b else float("nan"), "acceptance": 0.5}
                    for b in range(nblocks)]

        def walker_steps(self, nblocks):
            return self.traffic["nconf"] * self.traffic["nsteps_per_block"] * nblocks

        def release(self):
            pass

        def check(self):
            return {"energy_gap": 1e-6}

    cell = types.SimpleNamespace(
        config={"dtype": "float64"}, traffic={"nconf": 1000, "nsteps_per_block": 10}, chips=1,
        limits={"energy_gap": 1e-4},
        end_to_end=[{"name": "walker_steps_per_s", "unit": "walker-steps/s"},
                    {"name": "setup_s", "unit": "s"}],
        system_module=lambda: types.SimpleNamespace(System=lambda *a: None),
        method_module=lambda: types.SimpleNamespace(Run=Run))
    result, rows = run.execute(cell, 5, 11.0, 0, device="cpu", t_start=98.0)
    assert result["attempted"] == 4 and result["failed"] == 1 and not result["correct"]
    assert result["metrics"]["walker_steps_per_s"]["value"] == pytest.approx(4000.0)
    assert result["metrics"]["setup_s"]["value"] == pytest.approx(11.5)
    assert list(result)[-1] == "checks"
    assert rows == [("energy_gap", 1e-6, 1e-4)]


def test_import_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla", "flax", "pyqmc_tpu", "pyqmc_tpu.ops",
             "pyqmc_tpu_torch", "pyqmc_tpu_torch.method.vmc", "jaxtyping", "flaxen", "numpy"]
    assert run.forbidden_modules(names) == ["flax", "jax", "jax.numpy", "jaxlib.xla",
                                            "pyqmc_tpu", "pyqmc_tpu.ops"]


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=ROOT, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    top = _loaded_after("import qmcbench.run, qmcbench.sweep, qmcbench.repeat, qmcbench.control\n"
                        "from qmcbench import harness\n"
                        "for w in harness.load_benchmark()['workloads']:\n"
                        "    c = harness.Cell(w['name'])\n"
                        "    c.system_module(); c.method_module()\n"
                        "    [c.metric_reader(m['name']) for m in c.per_layer]\n"
                        "import pyqmc_tpu_torch.method.dmc, pyqmc_tpu_torch.method.vmc")
    assert not top & {"jax", "jaxlib", "flax", "pyqmc_tpu"}


def test_reference_imports_nothing_of_the_program():
    top = _loaded_after("import qmcbench.reference.molecule_sj")
    assert not top & {"jax", "jaxlib", "flax", "pyqmc_tpu", "pyqmc_tpu_torch"}


def test_seed_streams_take_large_seeds():
    seeds = {harness.seed_of(2**31 + 5, s) for s in range(1, 5)}
    assert len(seeds) == 4 and all(0 <= s < 2**63 for s in seeds)
    a = harness.sample_walkers(100, 10, 2**32 + 3, "cpu")
    assert torch.equal(a, harness.sample_walkers(100, 10, 2**32 + 3, "cpu"))
    assert len(set(a.tolist())) == 10
