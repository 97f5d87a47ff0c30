"""zamba2-1.2b — hybrid Mamba2 + shared attention [arXiv:2411.15242].

38 Mamba2 layers, d_model=2048, ssm_state=64; one weight-shared attention
block (32H MHA, d_ff=8192 MLP) applied every 6 SSM layers (6 applications,
each with its own KV cache), vocab=32000. Zamba2's per-application LoRA
adapters and input-embedding concat are simplified away (DESIGN.md §6).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    hybrid_attn_every=6,
    rope_theta=1e4,
    norm_eps=1e-5,
    # the unrolled hybrid structure (6 shared-attn applications + 38 SSM
    # blocks, python-level groups) runs full-sequence per microbatch;
    # accumulation keeps its live set inside HBM
    train_microbatches=4,
))
