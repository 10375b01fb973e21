"""codeqwen1.5-7b [dense] — qwen1.5 arch, full MHA (kv=32).
[hf:Qwen/CodeQwen1.5-7B] 32L d_model=4096 32H kv=32 d_ff=13440 vocab=92416."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, d_ff=13440, vocab=92416,
    n_heads=32, n_kv_heads=32, head_dim=128,
    attention="gqa", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="codeqwen-smoke", family="dense",
    n_layers=3, d_model=64, d_ff=128, vocab=512,
    n_heads=4, n_kv_heads=4, head_dim=16,
    attention="gqa",
)
