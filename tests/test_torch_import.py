"""The port stands alone: ``repro_torch`` and every submodule import with
jax blocked and without loading ``repro``; no file of the package imports
either; entry points refuse to run without CUDA unless the caller names the
CPU; and ``chip_smoke.py`` fails, printing no result, where it cannot run."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core.partition as part
import repro_torch.kernels.ops as ops
from repro_torch import configs
from repro_torch.core.bench_gen import generate
from repro_torch.core.durability import StoreDurability
from repro_torch.launch import serve as serve_driver
from repro_torch.models import from_reference, init_params
from repro_torch.serve import MultiTenantServer
from repro_torch.serve.serve_step import make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_every_submodule_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert int(out.stdout.strip()) >= 41


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_file_imports_jax_or_the_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    for name in _imports(ROOT / "chip_smoke.py"):
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = generate("SCI", n_versions=6, inserts=10, n_attrs=4, seed=0)
    args = (w.graph.indptr, w.graph.indices, w.graph.n_records, w.data,
            np.zeros(w.n_versions, np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        part.store_from_arrays(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        part.PartitionedCVD(w.graph, w.data, args[-1])
    with pytest.raises(RuntimeError, match="CUDA"):
        part.store_from_arrays(*args, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.checkout_batched(w.data, [[0, 1]])
    store = part.store_from_arrays(*args, device="cpu")
    assert store.device == torch.device("cpu")
    # restore rebuilds on the card unless the caller names the CPU
    dur = StoreDurability(str(tmp_path / "durable"))
    dur.snapshot(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        dur.restore()
    with pytest.raises(RuntimeError, match="CUDA"):
        dur.restore(device="cuda")
    assert dur.restore(device="cpu").store.device == torch.device("cpu")
    # a store on the default device, as made where the card was
    card = part.store_from_arrays(*args, device="cpu")
    card.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiTenantServer(card)
    with pytest.raises(ValueError):
        ops.resolve_device("meta")
    cfg = configs.smoke("zamba2_2_7b")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference(cfg, {})         # refused before the tree is read
    model = init_params(cfg, gen, "cpu")
    prefill = make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill(model, {"tokens": torch.zeros((1, 16), dtype=torch.int32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_driver.serve(cfg, requests=1, prompt_len=16, decode_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_driver.main(["--arch", "zamba2_2_7b", "--reduced"])


def _run_smoke(cwd: Path, script: Path, prelude: str = ""):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = (f"import sys, runpy; sys.argv = ['chip_smoke.py']; {prelude}"
            f"runpy.run_path({str(script)!r}, run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    """Without the repository around it the script exits non-zero and
    prints no result, even where a card is present."""
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    out = _run_smoke(tmp_path, script, prelude=(
        "import torch; torch.cuda.is_available = lambda: True; "))
    assert out.returncode != 0, out.stdout + out.stderr
    assert '"ok"' not in out.stdout
    assert "sources are missing" in out.stderr
