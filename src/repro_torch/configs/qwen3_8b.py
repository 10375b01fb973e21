"""qwen3-8b [dense] — GQA with qk_norm. [hf:Qwen/Qwen3-8B]
36L d_model=4096 32H kv=8 d_ff=12288 vocab=151936."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, d_ff=12288, vocab=151936,
    n_heads=32, n_kv_heads=8, head_dim=128,
    attention="gqa", qk_norm=True, rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen3-smoke", family="dense",
    n_layers=3, d_model=64, d_ff=128, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    attention="gqa", qk_norm=True,
)
