"""The port's invariants under repro-analyze (REPRO001-006), with no
baseline and nothing suppressed.

The port holds no lock, journal or tracing finding (REPRO002-006).  Its
REPRO001 findings are exactly the catalogued fault sites that nothing in
the port fires yet, each named with the ROADMAP item that makes it fire:
A.7 (durability: the journal and the disk) and A.8 (the multi-tenant
server).  Any other finding fails.  When A.7 or A.8 fires a site, its entry
here goes with it; the expected set only ever shrinks."""
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.analyze.engine import run  # noqa: E402

# site -> the ROADMAP item whose port makes it fire
UNFIRED = {
    "journal.append": "A.7",
    "journal.fsync": "A.7",
    "journal.replay": "A.7",
    "disk.torn_write": "A.7",
    "disk.bitflip": "A.7",
    "serve.admit": "A.8",
    "serve.shed": "A.8",
    "tenant.preempt": "A.8",
}
UNFIRED_RE = re.compile(r"catalogued fault site '([^']+)' never fires")


@pytest.fixture(scope="module")
def report():
    return run([str(REPO / "src" / "repro_torch")], baseline_path=None)


def test_nothing_baselined_or_suppressed(report):
    assert report["counts"]["suppressed"] == 0
    assert report["counts"]["baselined"] == 0
    assert report["rules"] == [f"REPRO00{k}" for k in range(1, 7)]


@pytest.mark.parametrize("rule", [f"REPRO00{k}" for k in range(2, 7)])
def test_no_finding_under_rule(report, rule):
    found = [f"{f['path']}:{f['line']}: {f['message']}"
             for f in report["findings"] if f["rule"] == rule]
    assert found == []


def test_repro001_is_exactly_the_unfired_sites(report):
    """Every REPRO001 finding is an unfired site of ``UNFIRED`` (the
    checkout docstring's catalogue count among them is not), and every
    site of ``UNFIRED`` is still unfired."""
    sites = []
    for f in report["findings"]:
        if f["rule"] != "REPRO001":
            continue
        match = UNFIRED_RE.search(f["message"])
        assert match, f"{f['path']}:{f['line']}: {f['message']}"
        sites.append(match.group(1))
    assert sorted(sites) == sorted(UNFIRED)
    assert set(UNFIRED.values()) == {"A.7", "A.8"}
