"""arctic-480b [moe] — 128 experts top-2 + dense residual branch.
[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H kv=8 d_ff=4864 vocab=32000."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, d_ff=4864, vocab=32000,
    n_heads=56, n_kv_heads=8, head_dim=128,
    attention="gqa",
    n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True,
)

SMOKE = ArchConfig(
    name="arctic-smoke", family="moe",
    n_layers=3, d_model=64, d_ff=96, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    attention="gqa",
    n_experts=8, top_k=2, d_ff_expert=96, dense_residual=True,
)
