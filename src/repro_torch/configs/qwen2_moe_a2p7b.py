"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H d_ff(expert)=1408
vocab=151936, 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,  # shared-expert aggregate handled via n_shared * d_expert
    vocab_size=151936,
    moe=MoEConfig(num_experts=60, top_k=4, n_shared_experts=4,
                  d_expert=1408, capacity_factor=1.25),
)
