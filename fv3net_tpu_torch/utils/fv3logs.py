"""Model-log parsing (the vcm.fv3.logs role: `FV3Log` dataclass and
`loads`, external/vcm/vcm/fv3/logs.py:37,61; a copy of the JAX
package's ``utils/fv3logs.py`` -- parses the per-step
statistics blocks the Fortran model prints: total-mass and
water-species summaries, plus date lines).

This framework's runtime emits the same block format from its metrics
logger (so reference tooling keeps working) and this parser reads
either a captured reference log or our own."""

from __future__ import annotations

import dataclasses
import datetime
import re
from collections import defaultdict
from typing import Dict, List, Sequence

# lines like: " total surface pressure =   982.345" or
# "mean dry air mass =  98234.2"
_STAT_RE = re.compile(
    r"^\s*(?P<name>[A-Za-z][A-Za-z0-9_ ().%/-]*?)\s*=\s*"
    r"(?P<value>[-+]?\d+\.?\d*(?:[eEdD][-+]?\d+)?)\s*$"
)
# date lines like "  fv3 time  2016 8 1 0 15 0"
_DATE_RE = re.compile(
    r"^\s*(?:fv3 time|Current model time:?)\s+"
    r"(?P<y>\d{4})\s+(?P<mo>\d{1,2})\s+(?P<d>\d{1,2})\s+"
    r"(?P<h>\d{1,2})\s+(?P<mi>\d{1,2})\s+(?P<s>\d{1,2})"
)


@dataclasses.dataclass
class FV3Log:
    """(vcm/fv3/logs.py:37): parsed statistics time series."""

    dates: List[datetime.datetime]
    totals: Dict[str, List[float]]
    ranges: Dict[str, List[tuple]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def variables(self) -> Sequence[str]:
        return sorted(self.totals)


def loads(text: str) -> FV3Log:
    """(vcm/fv3/logs.py:61): parse a captured model log."""
    dates: List[datetime.datetime] = []
    totals: Dict[str, List[float]] = defaultdict(list)
    for line in text.splitlines():
        md = _DATE_RE.match(line)
        if md:
            dates.append(
                datetime.datetime(
                    int(md["y"]), int(md["mo"]), int(md["d"]),
                    int(md["h"]), int(md["mi"]), int(md["s"]),
                )
            )
            continue
        ms = _STAT_RE.match(line)
        if ms:
            name = " ".join(ms["name"].strip().lower().split())
            value = float(
                ms["value"].replace("d", "e").replace("D", "E")
            )
            totals[name].append(value)
    return FV3Log(dates=dates, totals=dict(totals))


def dumps_statistics_block(
    date: datetime.datetime, stats: Dict[str, float]
) -> str:
    """Emit one statistics block in the parseable format (used by the
    runtime's metrics logger to stay reference-log-compatible)."""
    lines = [
        "fv3 time  %d %d %d %d %d %d"
        % (date.year, date.month, date.day, date.hour, date.minute,
           date.second)
    ]
    for name, value in stats.items():
        lines.append(" %s = %24.17g" % (name, value))
    return "\n".join(lines) + "\n"
