"""Reduced configurations and smoke shapes.

``reduced_config`` shrinks any architecture to a CPU-runnable member of
the same family for the per-arch smoke tests; the ``SMOKE_*`` shapes are
the reference's. The reference's ``input_specs`` (abstract input
stand-ins for its dry-run tools) is not ported: it waits for the dry-run
slice.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family stand-in: few layers, narrow width, small vocab.

    Preserves the family-defining structure (GQA ratio, QKV bias, MoE
    top-k, SSD dims, shared-attention period, enc-dec, frontend kind).
    """
    heads = 4 if cfg.n_heads else 0
    if cfg.n_heads:
        ratio = cfg.n_kv_heads / cfg.n_heads
        kv = max(1, round(heads * ratio))
    else:
        kv = 0
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
        dtype="float32",
        param_dtype="float32",
        moment_dtype="float32",
        remat="none",
        attn_q_chunk=8,
        attn_kv_chunk=16,
    )
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.swa_window:
        kw.update(swa_window=8)
    if cfg.hybrid_attn_every:
        kw.update(hybrid_attn_every=2)
    if cfg.is_encdec:
        kw.update(enc_layers=2, enc_seq=24)
    if cfg.frontend == "vision":
        kw.update(vis_tokens=8)
    return cfg.replace(**kw)


SMOKE_SHAPE = ShapeSpec("smoke", seq_len=16, global_batch=2, kind="train")
SMOKE_PREFILL = ShapeSpec("smoke_prefill", seq_len=16, global_batch=2,
                          kind="prefill")
SMOKE_DECODE = ShapeSpec("smoke_decode", seq_len=16, global_batch=2,
                         kind="decode")
