"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 -- decoder-only over EnCodec tokens [arXiv:2306.05284].

4 codebook streams with summed embeddings and 4 output heads; the
EnCodec tokenizer frontend is a STUB (input_specs provides the token
streams); the delay-pattern interleaving is applied by the server."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_act="gelu",
    frontend="codes",
    num_codebooks=4,
)
