"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff_expert=1024
vocab=50304; 64 experts top-8.  [arXiv:2409.02060; hf]"""
from ..models.moe import MoEConfig
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024,
    vocab=50304, head_dim=128,
    moe=MoEConfig(d_model=2048, n_experts=64, top_k=8, d_ff_expert=1024),
    tie_embeddings=False, microbatches=2,
)

SMOKE = ArchConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=64,
    vocab=256, head_dim=16,
    moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32),
    tie_embeddings=False, remat=False,
)
