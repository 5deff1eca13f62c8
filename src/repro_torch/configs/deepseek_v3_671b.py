"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MLA [arXiv:2412.19437].

MLA dims from the DeepSeek-V3 paper (q_lora 1536, kv_lora 512,
qk_nope 128, qk_rope 64, v 128); first 3 layers dense (d_ff 18432);
MTP head omitted."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,  # dense-layer FFN (first_k_dense layers)
    vocab_size=129280,
    first_k_dense=3,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, n_shared_experts=1,
                  d_expert=2048, capacity_factor=1.25),
)
