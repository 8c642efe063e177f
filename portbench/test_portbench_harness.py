"""The harness on the CPU: it finds a configuration, a traffic mix, an
entry and a metric by their names as new files, refuses to run without
a card, refuses a run that loaded JAX or the JAX package, and loads
nothing of either."""

import ast
import io
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.tiny import read_result, tiny_root  # noqa: E402

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def open_at_once(monkeypatch):
    monkeypatch.setattr(harness, "OPEN_AT_S", 0.0)

FAKE_ENTRY = '''
import torch


class Entry:
    def __init__(self, cfg, traffic, seed, device):
        self.dt_seconds = cfg["dt"]
        self.x = torch.full((4,), float(seed % 7), device=device)

    def prepare(self, i=None):
        pass

    def step(self):
        self.x = self.x * traffic_scale + 1.0

    def check(self):
        return {"fake_gap": float((self.x - self.x).abs().max())}


traffic_scale = 0.5
'''

FAKE_METRIC = '''
def read(ctx):
    return 1e3 * ctx.trace.window_s / ctx.trace.steps
'''


def add_fake_cell(root: Path):
    """A new configuration, traffic mix, entry and per-layer metric, each
    a file of its own, and their entries in BENCHMARK.json."""
    here = root / "portbench"
    (here / "configs" / "fake.json").write_text(json.dumps(
        {"dt": 60.0, "limits": {"fake_gap": 0.0}}))
    (here / "traffic" / "fake_mix.json").write_text(json.dumps(
        {"entry": "fake", "in_flight": 2, "trace_seconds": 0.01}))
    (here / "entries" / "fake.py").write_text(FAKE_ENTRY)
    (here / "metrics" / "fake_ms_per_step.py").write_text(FAKE_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fake", "source": "a test",
                             "file": "portbench/configs/fake.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fake.cell", "config": "fake",
                               "traffic": "fake_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "fake_ms_per_step", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "a test", "moves": "sdpd",
        "workloads": ["fake.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def run(root, *args, device="cpu"):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", "fake.cell", "--seed", "2147483651",
                       "--seconds", "0.05", *args], root=root,
                      device=device, out=out, err=err)
    return rc, out.getvalue(), err.getvalue()


def test_new_cell_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    add_fake_cell(root)
    rc, out, err = run(root, "--trace", "0")
    assert rc == 0, err
    res = read_result(out)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    # sdpd and setup_s hold in every cell, the others only in theirs
    assert set(res["metrics"]) == {"sdpd", "setup_s"}
    assert res["metrics"]["sdpd"]["unit"] == "days/day"
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"fake_gap": {"value": 0.0, "limit": 0.0}}
    assert err.strip().splitlines()[-1] == "fake_gap 0.0 limit 0.0"

    rc, out, err = run(root, "--trace", "1")
    assert rc == 0, err
    res = read_result(out)
    # the new metric is read; the device metrics find no device op on
    # the CPU and are left out of the line
    assert "fake_ms_per_step" in res["metrics"]
    assert "kernels_roofline" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the look for a card finds one here")
    root = tiny_root(tmp_path)
    add_fake_cell(root)
    rc, out, err = run(root, device=None)
    assert rc != 0 and out == ""
    assert "CUDA" in err


@pytest.mark.parametrize("name", ["jax", "flax.linen", "fv3net_tpu.grid"])
def test_forbidden_module_refuses_the_run(tmp_path, monkeypatch, name):
    root = tiny_root(tmp_path)
    add_fake_cell(root)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc, out, err = run(root)
    assert rc != 0 and out == ""
    assert name.split(".")[0] in err


STANDIN = "portbench_standin_for_jax"


def test_reader_that_loads_a_forbidden_module_refuses_the_run(
        tmp_path, monkeypatch):
    """The look for forbidden modules comes after every reader has been
    loaded: a new reader that imports one (here a stand-in name) leaves
    no result."""
    root = tiny_root(tmp_path)
    add_fake_cell(root)
    (tmp_path / f"{STANDIN}.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    (root / "portbench" / "metrics" / "fake_ms_per_step.py").write_text(
        f"import {STANDIN}\n" + FAKE_METRIC)
    monkeypatch.setattr(harness, "FORBIDDEN", (*harness.FORBIDDEN, STANDIN))
    try:
        rc, out, err = run(root, "--trace", "1")
    finally:
        sys.modules.pop(STANDIN, None)
    assert rc != 0 and out == ""
    assert STANDIN in err


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("fv3net_tpu_torch.dycore", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    forbidden = set(harness.FORBIDDEN)
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & forbidden, path
        if "reference" in path.parts:
            assert "fv3net_tpu_torch" not in tops, path
            assert "portbench" not in tops, path


def test_what_a_run_loads():
    """Every module a run loads (the harness, the dycore entry, every
    reader and the reference), in a fresh process: neither JAX nor the
    JAX package, compared by whole top-level names."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "here = Path(%r)\n"
        "for d in ('entries', 'metrics', 'end_to_end'):\n"
        "    for p in sorted((here / d).glob('*.py')):\n"
        "        harness.load_module(p, 'x_' + d + '_' + p.stem)\n"
        "import fv3net_tpu_torch.dycore.hydro\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n"
    ) % (str(HERE.parent), str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=HERE.parent).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & set(harness.FORBIDDEN)
    assert "portbench" in tops and "fv3net_tpu_torch" in tops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path, card):
    root = tiny_root(tmp_path)
    mix = root / "portbench" / "traffic" / "dycore.json"
    traffic = json.loads(mix.read_text())
    traffic["trace_seconds"] = 0.05  # a few C12 steps under the profiler
    mix.write_text(json.dumps(traffic))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", "c48x63.dycore", "--seed", "7",
                       "--seconds", "1", "--trace", "1"], root=root,
                      out=out, err=err)
    assert rc == 0, err.getvalue()
    res = read_result(out.getvalue())
    assert res["device"]["platform"] == "gpu"
    assert res["correct"] is True, res["checks"]
    assert 0.0 < res["metrics"]["kernels_roofline"]["value"] <= 100.0
