"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297; hf]"""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192,
    vocab=92544, head_dim=128, tie_embeddings=True, microbatches=1,
)

SMOKE = ArchConfig(
    name="internlm2-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=256, head_dim=16, tie_embeddings=True, remat=False,
)
