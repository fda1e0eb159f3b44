"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]

The anyres vision frontend is a STUB per the brief: ``input_specs`` provides
precomputed patch embeddings (B, n_patches=576, d_model) that replace the
first n_patches sequence positions; loss is masked over patch positions."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
    vocab=64000, head_dim=128, n_patches=576, tie_embeddings=False,
    microbatches=4,
)

SMOKE = ArchConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=256, head_dim=16, n_patches=8, tie_embeddings=False, remat=False,
)
