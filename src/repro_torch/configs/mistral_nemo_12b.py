"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1_000_000.0,
    tie_embeddings=False, microbatches=2,
)

SMOKE = ArchConfig(
    name="mistral-nemo-12b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=128,
    vocab=256, head_dim=16, rope_theta=1_000_000.0,
    tie_embeddings=False, remat=False,
)
