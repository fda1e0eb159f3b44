"""The port's invariants under repro-analyze (REPRO001-006), with no
baseline and nothing suppressed: every rule, REPRO001's fault-site
catalogue among them (all 22 sites fire in the port), finds nothing."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.analyze.engine import run  # noqa: E402


@pytest.fixture(scope="module")
def report():
    return run([str(REPO / "src" / "repro_torch")], baseline_path=None)


def test_nothing_baselined_or_suppressed(report):
    assert report["counts"]["suppressed"] == 0
    assert report["counts"]["baselined"] == 0
    assert report["rules"] == [f"REPRO00{k}" for k in range(1, 7)]


@pytest.mark.parametrize("rule", [f"REPRO00{k}" for k in range(1, 7)])
def test_no_finding_under_rule(report, rule):
    found = [f"{f['path']}:{f['line']}: {f['message']}"
             for f in report["findings"] if f["rule"] == rule]
    assert found == []
