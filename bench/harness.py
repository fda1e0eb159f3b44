"""What every cell shares: the program's configuration from a cell's
file, seeds derived from ``--seed``, the store built from generated
versions, and the device checks."""
from __future__ import annotations

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one the port must not load
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def subseed(seed: int, *keys: int) -> int:
    """An independent seed for one use of ``--seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *keys])
    return int(ss.generate_state(1, np.uint64)[0])


def arch_config(c: dict):
    """The program's ``ArchConfig`` from the configuration file ``c``:
    every key of the file that names one of its fields, a nested group
    (``ssd``, ``moe``, ``mla``) as that field's own config.  The file is
    what runs."""
    import dataclasses

    from repro_torch.models import mla, moe, ssd
    from repro_torch.models.transformer import ArchConfig
    groups = {"ssd": ssd.SSDConfig, "moe": moe.MoEConfig,
              "mla": mla.MLAConfig}
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: (groups[k](**v) if k in groups else v)
          for k, v in c.items() if k in names}
    return ArchConfig(**kw)


def reference(c: dict):
    """The plain reference module the configuration file names
    (``reference/<name>.py``)."""
    import importlib
    return importlib.import_module(f"bench.reference.{c['reference']}")


def build_store(versions, data: np.ndarray, device):
    """The program's partitioned store of generated versions: the version
    graph reduced to a tree, LyreSplit at a storage budget of 2|R|, the
    record pool ``data``."""
    from repro_torch.core import (lyresplit_for_budget, store_from_arrays,
                                  to_tree)
    from repro_torch.core.graph import BipartiteGraph
    from repro_torch.core.version_graph import VersionGraph
    indptr, indices = versions.csr()
    graph = BipartiteGraph(indptr=indptr, indices=indices,
                           n_records=versions.n_records)
    vg = VersionGraph()
    for step, parents in enumerate(versions.parents):
        vg.add_version(parents=parents, commit_t=float(step),
                       checkout_t=None if step == 0 else step - 0.5)
    tree, _ = to_tree(graph, vg)
    split = lyresplit_for_budget(tree, gamma=2.0 * versions.n_records)
    return store_from_arrays(indptr, indices, versions.n_records, data,
                             split.best.assignment, device=device)


def load_model(c: dict, cfg, flat: dict, device, trainable: bool):
    """The program's model holding the benchmark's weights ``flat``
    (through its weight carry, ``models.convert.load_reference``)."""
    from repro_torch.models import convert
    from repro_torch.models.transformer import Model

    from .weights import nested
    model = convert.load_reference(Model(cfg, None, device), nested(flat))
    return model.requires_grad_(trainable)
