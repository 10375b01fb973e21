"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0]
40L d_model=4096 32H kv=8 d_ff=12800 vocab=49155. Tied embeddings."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, d_ff=12800, vocab=49155,
    n_heads=32, n_kv_heads=8, head_dim=128,
    attention="gqa", tie_embeddings=True, rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="granite-smoke", family="dense",
    n_layers=3, d_model=64, d_ff=128, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    attention="gqa", tie_embeddings=True,
)
