"""seamless-m4t-medium [audio] — enc-dec, 12L each, d_model=1024 16H
(GQA kv=16) d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]

The audio (speech encoder) frontend is a STUB per the brief:
``input_specs`` provides precomputed frame embeddings (B, S, d_model) as
``enc_embeds``; the backbone here is the transformer enc-dec."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096, vocab=256206, head_dim=64, tie_embeddings=True,
    microbatches=2,
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=256, head_dim=16, tie_embeddings=True, remat=False,
)
