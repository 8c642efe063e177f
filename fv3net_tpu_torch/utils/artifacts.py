"""Workflow lineage breadcrumbs
(external/artifacts/fv3net/artifacts/metadata.py; a copy of the JAX
package's ``utils/artifacts.py``).

Every reference workflow step prints a one-line JSON ``step_metadata``
record (job type, output URL, commit, input dependencies, argv) so runs
can be traced end-to-end; training additionally logs fact records
(`fv3fit/train.py:177-179`, `segmented_run/append.py:47-51`,
`train_microphysics.py:531-537` log_fact_json).  Same contract here,
stdout JSON lines consumable by any log scraper.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Any, List, Mapping, Optional


def _current_commit() -> Optional[str]:
    sha = os.getenv("COMMIT_SHA")
    if sha:
        return sha
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=5,
            ).stdout.strip()
            or None
        )
    except Exception:
        return None


@dataclasses.dataclass
class StepMetadata:
    job_type: str
    url: str
    commit: Optional[str] = None
    dependencies: Optional[Mapping[str, str]] = None
    args: Optional[List[str]] = None
    env_vars: Optional[Mapping[str, str]] = None

    def __post_init__(self):
        if self.commit is None:
            self.commit = _current_commit()

    def print_json(self):
        print(json.dumps({"step_metadata": dataclasses.asdict(self)}))

    def write(self, path: str):
        """Also persist the breadcrumb next to the artifact."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"step_metadata": dataclasses.asdict(self)}, f)


def log_fact_json(
    data: Mapping[str, Any],
    kind: str = "metrics",
    labels: Optional[Mapping[str, str]] = None,
) -> None:
    """Structured fact record (metadata.py:log_fact_json)."""
    payload: dict = {"json": dict(data)}
    payload["labels"] = dict(kind=kind, **(labels or {}))
    print(json.dumps(payload))
