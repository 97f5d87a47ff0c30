"""Mixture-of-Experts FFN (Mixtral / Grok-1 style: top-2 of 8, SwiGLU).

Mirrors `repro.models.moe` on one device. Dispatch is the *sort-based
capacity* scheme: assignments are sorted by expert (a stable sort), ranked
within expert, and scattered into an [E, cap, D] buffer that feeds dense
per-expert GEMMs; assignments past an expert's capacity are dropped and
contribute zero on combine (GShard-style residual fallback).

The expert SwiGLU is three batched matrix products (`torch.bmm`), as the
reference leaves its three einsums to XLA outside any kernel. Routing
runs step by step as the reference's: float32 router logits and softmax,
top-k with the weights renormalised over the k, the Switch-style
load-balance aux, the stable sort, the rank within each expert and
``keep = rank < cap``; combine is a scatter-add in ``cfg.dtype``.

The top-k is a stable descending sort of the probabilities, so that tied
probabilities pick the lower expert index first, as `jax.lax.top_k` does
(`torch.topk` promises no order among ties). Dropped assignments scatter
into a spare row ``cap`` of each expert's buffer, which is cut off before
the GEMMs, where the reference scatters out of bounds with
``mode="drop"``: no host synchronisation on the count of drops.

Router logits are computed in float32, or in float64 for float64 inputs
(the reference's model has no float64; the port's float64 runs check
gradients).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dtype, normal_init


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    pdt = _dtype(cfg.param_dtype)
    return {
        "router": normal_init(gen, (d, e), 0.02, torch.float32, device),
        "w1": normal_init(gen, (e, d, f), 0.02, pdt, device),
        "w3": normal_init(gen, (e, d, f), 0.02, pdt, device),
        "w2": normal_init(gen, (e, f, d), 0.02 / (2 * cfg.n_layers) ** 0.5,
                          pdt, device),
    }


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


class DispatchMeta:
    """Sorted-assignment metadata linking tokens <-> expert buffer slots:
    ``eid_s``/``tok_s``/``wgt_s`` the assignments' expert, token and
    weight in expert order, ``rank_c`` each one's slot in its expert's
    buffer (``cap`` where dropped), ``keep`` whether it fits, ``t`` the
    tokens and ``cap`` the capacity."""

    def __init__(self, eid_s, tok_s, wgt_s, rank_c, keep, t, cap):
        self.eid_s, self.tok_s, self.wgt_s = eid_s, tok_s, wgt_s
        self.rank_c, self.keep, self.t, self.cap = rank_c, keep, t, cap


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities of each row, largest first, ties to the
    lower index (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route_and_dispatch(x2d: torch.Tensor, router: torch.Tensor,
                       cfg: ModelConfig
                       ) -> tuple[torch.Tensor, DispatchMeta, torch.Tensor]:
    """Route tokens and scatter them into [E, cap, D] expert buffers.

    Returns (buf, meta, aux_loss). Dropped (over-capacity) assignments
    contribute zero on combine."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    cdt = _dtype(cfg.dtype)
    cap = _capacity(t, cfg)
    rdt = torch.promote_types(x2d.dtype, torch.float32)

    logits = x2d.to(rdt) @ router.to(rdt)                # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)                      # [T, k]
    weights = top_p / top_p.sum(dim=-1, keepdim=True)

    # Switch-style load-balance auxiliary: E * sum_e f_e * P_e
    eid = top_i.reshape(-1)                              # [T*k]
    # counts per expert [E] (`index_add_`, not `bincount`: it also runs
    # on the dry run's meta tensors)
    counts = torch.zeros(e, dtype=eid.dtype, device=eid.device) \
        .index_add_(0, eid, torch.ones_like(eid))
    dispatch_frac = counts.to(rdt) / (t * k)
    aux = e * torch.sum(dispatch_frac * probs.mean(dim=0))

    tok = torch.arange(t, device=x2d.device).repeat_interleave(k)
    wgt = weights.reshape(-1)
    order = torch.argsort(eid, stable=True)
    eid_s, tok_s, wgt_s = eid[order], tok[order], wgt[order]
    starts = torch.cumsum(counts, 0) - counts            # exclusive
    rank = torch.arange(t * k, device=x2d.device) - starts[eid_s]
    keep = rank < cap

    # scatter tokens into [E, cap, D]; dropped rows land in row ``cap``
    rank_c = torch.where(keep, rank, torch.full_like(rank, cap))
    buf = torch.zeros((e, cap + 1, d), dtype=cdt, device=x2d.device)
    buf[eid_s, rank_c] = x2d[tok_s].to(cdt)
    meta = DispatchMeta(eid_s, tok_s, wgt_s, rank_c, keep, t, cap)
    return buf[:, :cap], meta, aux


def expert_gemms(buf: torch.Tensor, w1, w3, w2, cfg: ModelConfig
                 ) -> torch.Tensor:
    """Dense per-expert SwiGLU. buf: [E, cap, D]; w1, w3: [E, D, F];
    w2: [E, F, D]. Returns [E, cap, D]."""
    cdt = _dtype(cfg.dtype)
    h1 = torch.bmm(buf, w1.to(cdt))
    h3 = torch.bmm(buf, w3.to(cdt))
    return torch.bmm(F.silu(h1) * h3, w2.to(cdt))


def combine(out_buf: torch.Tensor, meta: DispatchMeta, d: int,
            cfg: ModelConfig) -> torch.Tensor:
    """Gather expert outputs back to token order, weighted. -> [T, D]."""
    cdt = _dtype(cfg.dtype)
    contrib = out_buf[meta.eid_s, torch.clamp(meta.rank_c, max=meta.cap - 1)]
    contrib = contrib * (meta.wgt_s * meta.keep).to(cdt)[:, None]
    out = torch.zeros((meta.t, d), dtype=cdt, device=out_buf.device)
    return out.index_add(0, meta.tok_s, contrib)


def moe_ffn_local(x2d: torch.Tensor, p: dict, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-local MoE. x2d: [T, D] -> ([T, D], aux_loss scalar)."""
    buf, meta, aux = route_and_dispatch(x2d, p["router"], cfg)
    out_buf = expert_gemms(buf, p["w1"], p["w3"], p["w2"], cfg)
    return combine(out_buf, meta, x2d.shape[1], cfg), aux
