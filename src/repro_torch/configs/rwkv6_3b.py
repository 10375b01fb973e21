"""rwkv6-3b (Finch) [ssm] — attention-free, data-dependent decay.
[arXiv:2404.05892] 32L d_model=2560 d_ff=8960 vocab=65536."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, d_ff=8960, vocab=65536,
    attention="none", rwkv=True, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=128, d_ff=256, vocab=512,
    attention="none", rwkv=True, tie_embeddings=True,
)
