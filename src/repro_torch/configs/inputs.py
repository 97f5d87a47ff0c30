"""Input stand-ins for every (architecture x shape) cell, reduced
configurations and smoke shapes (mirrors `repro.configs.inputs`).

``input_specs`` returns the inputs of the entry point a shape's kind
runs, as meta-device tensors (the reference's ``ShapeDtypeStruct``s:
shapes and dtypes, nothing allocated):

  train    -> ``train_step``   {"batch": tokens/labels (+frames/patches)}
  prefill  -> ``prefill``      {"batch": tokens (+frames/patches)}
  decode   -> ``serve_step``   {"tokens", "caches", "positions"}: one new
              token against a KV / SSM cache of ``seq_len``

``concrete=True`` materialises them instead (ones for integers, zeros
otherwise) on ``device``. ``reduced_config`` shrinks any architecture to
a CPU-runnable member of the same family for the per-arch smoke tests;
the ``SMOKE_*`` shapes are the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import DeviceLike, resolve_device


def _mk(concrete: bool, device):
    dev = resolve_device(device) if concrete else torch.device("meta")

    def f(shape, dtype):
        if concrete and not dtype.is_floating_point:
            return torch.ones(shape, dtype=dtype, device=dev)
        return torch.zeros(shape, dtype=dtype, device=dev) if concrete \
            else torch.empty(shape, dtype=dtype, device=dev)
    return f, dev


def _frontend_inputs(cfg: ModelConfig, b: int, mk) -> dict:
    from repro_torch.models.layers import _dtype

    adt = _dtype(cfg.dtype)
    out = {}
    if cfg.family == "audio":
        out["frames"] = mk((b, cfg.enc_seq, cfg.d_model), adt)
    if cfg.frontend == "vision":
        out["patches"] = mk((b, cfg.vis_tokens, cfg.d_model), adt)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                concrete: bool = False, device: DeviceLike = None) -> dict:
    """Stand-ins for every model input of this (arch, shape) cell: meta
    tensors, or with ``concrete`` real ones on ``device``."""
    from repro_torch.models.model import init_cache

    mk, dev = _mk(concrete, device)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": mk((b, s), torch.int32),
                 "labels": mk((b, s), torch.int32)}
        batch.update(_frontend_inputs(cfg, b, mk))
        return {"batch": batch}
    if shape.kind == "prefill":
        batch = {"tokens": mk((b, s), torch.int32)}
        batch.update(_frontend_inputs(cfg, b, mk))
        return {"batch": batch}
    if shape.kind == "decode":
        return {"tokens": mk((b, 1), torch.int32),
                "caches": init_cache(cfg, b, s, device=dev),
                "positions": mk((b,), torch.int32)}
    raise ValueError(shape.kind)


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
