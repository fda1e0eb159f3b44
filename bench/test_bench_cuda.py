"""On the card, at each cell's own size: the control (the reference in
float8 in the program's place) and each fault the cell can have make
``correct`` false, and a sound run is correct.  Skipped without a card;
run there with ``python -m pytest -m cuda bench``."""
import pytest
import torch

from bench import faults, manifest
from bench.cells import prefill, train

RUNNERS = {"prefill": prefill, "train": train}
FAULTS = {"internlm2-1.8b.prefill-conv": ["alter_token", "alter_prompt"],
          "internlm2-1.8b.train-4k": ["half_batch", "unchanged_state",
                                      "stale_once_warm"]}


def verdict(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_control_is_not_correct(workload, cuda_device):
    cell = manifest.cell(workload)
    out = RUNNERS[cell.traffic["kind"]].run(cell, 2**31 + 101, 3.0, False,
                                            cuda_device, control=True)
    assert verdict(out["checks"])
    assert not verdict(out["control_checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in
                                            sorted(FAULTS.items())
                                            for f in fs])
def test_fault_is_not_correct(workload, fault, cuda_device):
    cell = manifest.cell(workload)
    out = RUNNERS[cell.traffic["kind"]].run(cell, 2**31 + 102, 3.0, False,
                                            cuda_device,
                                            fault=faults.FAULTS[fault])
    assert not verdict(out["checks"])
    torch.cuda.empty_cache()
