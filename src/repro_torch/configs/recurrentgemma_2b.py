"""recurrentgemma-2b (Griffin) [hybrid] — RG-LRU + local attention, 1:2.
[arXiv:2402.19427] 26L d_model=2560 10H kv=1(MQA) d_ff=7680 vocab=256000."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, d_ff=7680, vocab=256000,
    n_heads=10, n_kv_heads=1, head_dim=256,
    attention="local", local_window=2048,
    rglru=True, block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560, conv_width=4, tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=4, d_model=64, d_ff=128, vocab=512,
    n_heads=2, n_kv_heads=1, head_dim=32,
    attention="local", local_window=32,
    rglru=True, block_pattern=("rglru", "rglru", "attn"),
    lru_width=64, conv_width=4, tie_embeddings=True,
)
