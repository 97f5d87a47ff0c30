"""mamba2-1.3b — SSD state-space model [arXiv:2405.21060].

48L d_model=2048 attention-free; ssm_state=128, expand 2 (d_inner=4096),
head_dim 64 (64 SSD heads), conv width 4, vocab 50280 (GPT-NeoX tokenizer),
tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    norm_eps=1e-5,
))
