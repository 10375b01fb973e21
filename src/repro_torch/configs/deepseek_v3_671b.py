"""deepseek-v3-671b [moe] — MLA + 1 shared/256 routed top-8 MoE + MTP.
[arXiv:2412.19437; hf] 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280."""
from repro_torch.models.config import ArchConfig

ARCH = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, d_ff=18432, vocab=129280,
    n_heads=128, n_kv_heads=128, head_dim=128,
    attention="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, d_ff_expert=2048, n_shared_experts=1,
    first_k_dense=3, mtp=True,
)

SMOKE = ArchConfig(
    name="deepseek-v3-smoke", family="moe",
    n_layers=4, d_model=64, d_ff=128, vocab=512,
    n_heads=4, n_kv_heads=4, head_dim=16,
    attention="mla",
    q_lora_rank=32, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
    first_k_dense=1, mtp=True,
)
