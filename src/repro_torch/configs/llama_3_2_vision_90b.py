"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision] 100L d_model=8192 64H kv=8 d_ff=28672 vocab=128256.
Vision frontend is a STUB: input_specs provides precomputed patch embeddings."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, d_ff=28672, vocab=128256,
    n_heads=64, n_kv_heads=8, head_dim=128,
    attention="gqa", xattn_period=4, n_img_tokens=1601,
    rope_theta=5e5,
)

SMOKE = ArchConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=5, d_model=64, d_ff=128, vocab=512,
    n_heads=4, n_kv_heads=2, head_dim=16,
    attention="gqa", xattn_period=4, n_img_tokens=16,
)
