"""OrpheusDB core on PyTorch: the five CVD storage models, the AGGLO/KMEANS
baselines (``core.baselines``), the CVD graph, LYRESPLIT partitioning, the
partitioned store and its batched checkout engine, the write-ahead journal
and durable snapshots, and the versioned query layer."""
from .bench_gen import Workload, generate
from .checkout import (DensityStats, Superblock, WaveResult,
                       build_superblock, checkout_partitioned,
                       checkout_partitioned_perpart, checkout_rlists,
                       checkout_versions, checkout_versions_loop,
                       checkout_wave, estimate_superblock_bytes,
                       evict_superblocks, get_density_stats, get_superblock,
                       plan_wave, take_superblock)
from .datamodels import (ALL_MODELS, CombinedTable, DeltaBased, SplitByRlist,
                         SplitByVlist, TablePerVersion)
from .durability import (RestoredStore, StoreDurability, StoreSnapshot,
                         snapshot_roundtrip_equal)
from .faults import (SITES as FAULT_SITES, FaultPlan, GuardedCounter,
                     InjectedFault, fault_point, inflight_counter)
from .graph import BipartiteGraph, checkout_cost, storage_cost, union_size
from .lyresplit import SplitResult, lyresplit, lyresplit_for_budget
from .partition import (PartitionedCVD, per_version_partitions,
                        single_partition, store_from_arrays)
from .version_graph import VersionGraph, WeightedTree, edge_weights, to_tree

__all__ = [
    "BipartiteGraph", "checkout_cost", "storage_cost", "union_size",
    "checkout_partitioned", "checkout_partitioned_perpart",
    "checkout_rlists", "checkout_versions", "checkout_versions_loop",
    "checkout_wave", "Superblock", "WaveResult", "build_superblock",
    "get_superblock", "plan_wave", "DensityStats", "get_density_stats",
    "estimate_superblock_bytes", "evict_superblocks", "take_superblock",
    "VersionGraph", "WeightedTree", "to_tree", "edge_weights",
    "lyresplit", "lyresplit_for_budget", "SplitResult",
    "PartitionedCVD", "single_partition", "per_version_partitions",
    "store_from_arrays",
    "ALL_MODELS", "CombinedTable", "DeltaBased", "SplitByRlist",
    "SplitByVlist", "TablePerVersion",
    "FAULT_SITES", "FaultPlan", "GuardedCounter", "InjectedFault",
    "fault_point", "inflight_counter",
    "RestoredStore", "StoreDurability", "StoreSnapshot",
    "snapshot_roundtrip_equal",
    "generate", "Workload",
]
