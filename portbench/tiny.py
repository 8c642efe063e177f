"""A checkout's benchmark cut to a test run's size on the CPU: the data
folders of ``portbench`` copied under a temporary root, with a
configuration at C12 x 8 that keeps the committed configuration's
scheme and limits, so that the tests drive the harness as a run does."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
FOLDERS = ("traffic", "entries", "metrics", "end_to_end")


def tiny_root(tmp: Path, config: str = "C48x63", **changes) -> Path:
    """`tmp` laid out as a checkout whose configuration `config` is cut
    to C12 x 8 (`changes` override any key)."""
    (tmp / "portbench").mkdir(parents=True, exist_ok=True)
    for d in FOLDERS:
        shutil.copytree(HERE / d, tmp / "portbench" / d)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == config)
    cfg = json.loads((HERE.parent / entry["file"]).read_text())
    cfg.update(resolution=12, nz=8)
    cfg.update(changes)
    target = tmp / entry["file"]
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def read_result(text: str) -> dict:
    """The result: the last line of a run's standard output."""
    return json.loads(text.strip().splitlines()[-1])
