"""Analytic parameter counts and model FLOPs (mirrors
`repro.launch.roofline`).

`param_counts` and `model_flops` are pure Python over the config and
port verbatim: the standard 6ND / 2ND conventions plus the attention and
SSD terms. `roofline_from_record` reads a dry-run record of the port
(`repro_torch.launch.dryrun`). The reference's hardware constants are a
TPU v5e's and are not carried over; the port uses an NVIDIA H100 SXM's
nominal figures, named below (NVIDIA's data sheet, dense rates at the
700 W power limit; a card set lower runs slower).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec

H100_SXM_BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
H100_SXM_HBM_BYTES_PER_S = 3.35e12
H100_SXM_NVLINK_BYTES_PER_S = 450e9   # one direction (900 GB/s both)


# ---------------------------------------------------------------------------
# analytic parameter counts and step FLOPs
# ---------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> dict:
    """Analytic parameter counts: total and active-per-token."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, g = cfg.n_heads, cfg.n_kv_heads
    attn = d * (h + 2 * g) * dh + h * dh * d
    if cfg.qkv_bias:
        attn += (h + 2 * g) * dh
    if cfg.n_experts:
        ffn_total = cfg.n_experts * 3 * d * cfg.d_ff + d * cfg.n_experts
        ffn_active = cfg.top_k * 3 * d * cfg.d_ff + d * cfg.n_experts
    elif cfg.d_ff:
        ffn_total = ffn_active = 3 * d * cfg.d_ff
    else:
        ffn_total = ffn_active = 0

    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.d_inner
        n = cfg.ssm_state
        conv_dim = d_in + 2 * n
        d_proj = 2 * d_in + 2 * n + cfg.ssm_heads
        ssm = d * d_proj + cfg.ssm_conv * conv_dim + d_in * d + d_in
        per_layer_total = per_layer_active = ssm
    else:
        per_layer_total = attn + ffn_total
        per_layer_active = attn + ffn_active

    total = cfg.n_layers * per_layer_total
    active = cfg.n_layers * per_layer_active
    if cfg.family == "hybrid":
        shared = attn + 3 * d * cfg.d_ff
        n_apps = cfg.n_layers // cfg.hybrid_attn_every
        total += shared                      # weight-shared: stored once
        active += shared * n_apps            # ...but applied n_apps times
    if cfg.is_encdec:
        enc = cfg.enc_layers * (attn + 2 * d * cfg.d_ff)
        total += enc
        active += enc
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return {"total": total, "active": active, "embed": embed,
            "unembed": cfg.vocab * d}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Useful FLOPs of one step of this cell (fwd+bwd for train; fwd for
    prefill; one token for decode), standard 6ND/2ND conventions."""
    pc = param_counts(cfg)
    b, s = shape.global_batch, shape.seq_len
    d, dh, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads

    def attn_core(tokens, kv_len, causal=True):
        # score + PV matmuls, causal halves the work
        full = 4.0 * tokens * kv_len * h * dh
        return full / 2 if causal else full

    def ssd_core(tokens):
        hh, p, n, l = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
            cfg.ssm_chunk
        # intra-chunk quadratic + state build/apply per token
        return tokens * hh * (2.0 * l * (n + p) + 4.0 * n * p)

    if shape.kind == "train":
        tokens = b * s
        f = 6.0 * pc["active"] * tokens + 6.0 * pc["unembed"] * tokens
        if cfg.family in ("ssm", "hybrid"):
            f += 3.0 * cfg.n_layers * ssd_core(tokens)
            if cfg.family == "hybrid":
                n_apps = cfg.n_layers // cfg.hybrid_attn_every
                f += 3.0 * n_apps * attn_core(tokens, s)
        else:
            win = cfg.swa_window or s
            f += 3.0 * cfg.n_layers * attn_core(tokens, min(s, win))
        if cfg.is_encdec:
            f += 3.0 * cfg.enc_layers * attn_core(b * cfg.enc_seq,
                                                  cfg.enc_seq, causal=False)
        return f

    if shape.kind == "prefill":
        tokens = b * s
        f = 2.0 * (pc["active"] + pc["unembed"] / s) * tokens
        if cfg.family in ("ssm", "hybrid"):
            f += cfg.n_layers * ssd_core(tokens)
            if cfg.family == "hybrid":
                f += (cfg.n_layers // cfg.hybrid_attn_every) \
                    * attn_core(tokens, s)
        else:
            win = cfg.swa_window or s
            f += cfg.n_layers * attn_core(tokens, min(s, win))
        return f

    # decode: one new token against a cache of length s
    f = 2.0 * (pc["active"] + pc["unembed"]) * b
    if cfg.family in ("ssm", "hybrid"):
        hh, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        f += cfg.n_layers * b * hh * 6.0 * n * p
        if cfg.family == "hybrid":
            f += (cfg.n_layers // cfg.hybrid_attn_every) \
                * attn_core(b, s, causal=False)
    else:
        win = cfg.swa_window or s
        f += cfg.n_layers * attn_core(b, min(s, win), causal=False)
    if cfg.is_encdec:
        f += cfg.n_layers * attn_core(b, cfg.enc_seq, causal=False)
    return f


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops: float
    hlo_flops_global: float
    useful_frac: float
    fits: bool
    peak_gib: float

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline-limited step time."""
        return self.compute_s * self.useful_frac / max(self.step_s, 1e-30)


def roofline_from_record(rec: dict, cfg: ModelConfig,
                         shape: ShapeSpec) -> RooflineRow:
    """The roofline row of a dry-run record: its per-rank FLOPs, bytes and
    collective wire bytes over an H100's peak rates."""
    n_dev = 1
    for v in rec["mesh_shape"].values():
        n_dev *= v
    hlo = rec["hlo"]
    compute = hlo["flops"] / H100_SXM_BF16_FLOPS
    memory = hlo["bytes_accessed"] / H100_SXM_HBM_BYTES_PER_S
    coll = hlo["total_collective_wire"] / H100_SXM_NVLINK_BYTES_PER_S
    bound = max((compute, "compute"), (memory, "memory"),
                (coll, "collective"))[1]
    mf = model_flops(cfg, shape)
    hlo_global = hlo["flops"] * n_dev
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute, memory_s=memory, collective_s=coll,
        bound=bound, model_flops=mf, hlo_flops_global=hlo_global,
        useful_frac=mf / max(hlo_global, 1e-30), fits=rec["fits"],
        peak_gib=rec["memory"]["peak_bytes"] / 2 ** 30)
