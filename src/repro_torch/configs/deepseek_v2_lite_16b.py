"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff_expert=1408
vocab=102400; MLA kv_lora=512; 2 shared + 64 routed experts top-6.
[arXiv:2405.04434; hf]

Note: the assignment line reads "MoE 64e top-6 ... 2 shared+160 routed"; the
two clauses conflict — 160 routed belongs to full V2.  We follow the leading
spec and the HF V2-Lite config: 64 routed experts, top-6, 2 shared, with the
first layer dense (d_ff 10944) per V2-Lite.
"""
from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=10944,
    vocab=102400, attn_type="mla",
    mla=MLAConfig(d_model=2048, n_heads=16, kv_lora=512,
                  qk_nope=128, qk_rope=64, v_head=128),
    moe=MoEConfig(d_model=2048, n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared=2, d_ff_shared=2816),
    first_dense=1, tie_embeddings=True, microbatches=4,
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=256, attn_type="mla",
    mla=MLAConfig(d_model=64, n_heads=4, kv_lora=32, qk_nope=16,
                  qk_rope=8, v_head=16),
    moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                  n_shared=1, d_ff_shared=64),
    first_dense=1, tie_embeddings=True, remat=False,
)
