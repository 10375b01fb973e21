"""mistral-nemo-12b [dense] — GQA, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407]
40L d_model=5120 32H kv=8 d_ff=14336 vocab=131072, head_dim=128."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, d_ff=14336, vocab=131072,
    n_heads=32, n_kv_heads=8, head_dim=128,
    attention="gqa", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="nemo-smoke", family="dense",
    n_layers=3, d_model=64, d_ff=128, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    attention="gqa",
)
