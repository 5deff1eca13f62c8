"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 -- pixtral-ViT frontend (STUB: precomputed patch embeddings
per task spec) + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    frontend="patches",
    num_patches=1024,
)
