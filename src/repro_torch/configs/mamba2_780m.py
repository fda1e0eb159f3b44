"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) vocab=50280
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from ..models.ssd import SSDConfig
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, vocab=50280,
    ssd=SSDConfig(d_model=1536, d_state=128, headdim=64, chunk=256),
    tie_embeddings=True, microbatches=2,
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=256,
    ssd=SSDConfig(d_model=64, d_state=16, headdim=16, chunk=16),
    tie_embeddings=True, remat=False,
)
