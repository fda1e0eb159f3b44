"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + SHARED attention block.
[arXiv:2411.15242; hf]

Adaptation notes (DESIGN.md): the shared transformer block (one set of
params, applied every ``shared_every`` SSD layers — 54/6 = 9 applications)
reproduces Zamba2's parameter-sharing scheme; the per-application LoRA
deltas of the released model are omitted (noted simplification)."""
from ..models.ssd import SSDConfig
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
    vocab=32000, head_dim=80,
    ssd=SSDConfig(d_model=2560, d_state=64, headdim=64, chunk=256),
    shared_every=6, tie_embeddings=True, microbatches=4,
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=256, head_dim=16,
    ssd=SSDConfig(d_model=64, d_state=16, headdim=16, chunk=16),
    shared_every=2, tie_embeddings=True, remat=False,
)
