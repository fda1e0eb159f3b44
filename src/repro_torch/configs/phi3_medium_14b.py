"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352; RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv=10, d_ff=17920,
    vocab=100352, head_dim=128, tie_embeddings=False,
    microbatches=2,
)

SMOKE = ArchConfig(
    name="phi3-medium-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=128,
    vocab=256, head_dim=16, tie_embeddings=False, remat=False,
)
