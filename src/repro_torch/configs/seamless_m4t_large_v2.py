"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.
[arXiv:2308.11596] 24L d_model=1024 16H d_ff=8192 vocab=256206.
Audio frontend is a STUB: input_specs provides precomputed frame embeddings."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, d_ff=8192, vocab=256206,
    n_heads=16, n_kv_heads=16, head_dim=64,
    attention="gqa", enc_dec=True, n_enc_layers=24,
)

SMOKE = ArchConfig(
    name="seamless-smoke", family="audio",
    n_layers=2, d_model=64, d_ff=128, vocab=512,
    n_heads=4, n_kv_heads=4, head_dim=16,
    attention="gqa", enc_dec=True, n_enc_layers=2,
)
