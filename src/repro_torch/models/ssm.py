"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Mirrors `repro.models.ssm` for one device. Prefill runs the chunked SSD
scan through `repro_torch.kernels.ops.ssd_scan`: the hand-written kernel
on CUDA tensors, its plain version on CPU tensors. The route follows the
device, not ``cfg.attn_impl``, as attention's does. `ssd_chunked` is the
reference's blockwise einsum form, kept as a second, independent oracle.
Decode is the plain linear recurrence on a [B, H, P, N] state plus a
[B, K-1, conv_dim] conv state.

Two departures:
- `ssm_prefill_with_cache` left-pads the conv tail with zeros when the
  prompt is shorter than K-1 tokens, which is what the causal conv means
  (`_causal_conv` pads K-1 zeros). The reference keeps the prompt's
  S < K-1 rows only, and its engine writes them at the front of the
  slot's K-1 rows, so the first decode step convolves them in the wrong
  places, and with what the slot held before.
- `_causal_conv` sums its K products in float32 and rounds once, as the
  decode step's einsum does, where the reference rounds every product and
  sum in the model dtype. In bf16 the prefill and the decode step then
  agree (a prompt prefilled and one decoded token by token give the same
  conv outputs); at float32 nothing changes.

Under a live mesh (`repro_torch.parallel.axes.use_sharding`) a block runs
data-parallel: its input is placed on the batch axes only (the
reference's replicated ``zxbcdt`` pin), its weights are gathered whole,
and each rank runs the one-device block on its own rows (the SSD kernel
on every head of them); the output and the new cache go back to their
placements. The reference's finer pins (x and dt over heads for the
scan, the conv's x part over ``model``) are not followed: tensor
parallelism inside a Mamba2 block is not ported (ROADMAP queue 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import _dtype, normal_init, rms_norm
from repro_torch.parallel.axes import (SINGLE_DEVICE_RULES, constrain,
                                       current_mesh, like, local,
                                       use_sharding)

N_GROUPS = 1  # B/C projection groups (Mamba2-1.3b uses 1)


class SSMCache(NamedTuple):
    """Decode-time SSM cache; the model's carries a leading layer axis."""

    conv: torch.Tensor   # [..., B, K-1, conv_dim] last conv inputs
    state: torch.Tensor  # [..., B, H, P, N] recurrent state (f32)


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    nh = cfg.ssm_heads
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_in + 2 * N_GROUPS * n
    return d_in, nh, p, n, conv_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random parameters at the reference's scales, drawn from ``gen`` in
    the reference's order (in_proj, conv_w, dt, out_proj). Every leaf is
    made on the generator's device, the computed ones (A_log, dt_bias)
    included, and moved to ``device`` (default: the generator's), so a CPU
    generator gives the same leaves on every device."""
    d = cfg.d_model
    d_in, nh, _, n, conv_dim = _dims(cfg)
    pdt = _dtype(cfg.param_dtype)
    home = gen.device
    # in_proj order: [z (d_in), x (d_in), B (g*n), C (g*n), dt (nh)]
    d_proj = 2 * d_in + 2 * N_GROUPS * n + nh
    in_proj = normal_init(gen, (d, d_proj), 0.02, pdt)
    conv_w = normal_init(gen, (cfg.ssm_conv, conv_dim), 0.2, pdt)
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=home)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    f32 = dict(dtype=torch.float32, device=home)
    p = {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=pdt, device=home),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.exp(dt) - 1.0 + 1e-9),  # inverse softplus
        "gated_norm": torch.ones((d_in,), **f32),
        "out_proj": normal_init(
            gen, (d_in, d), 0.02 / (2 * cfg.n_layers) ** 0.5, pdt),
    }
    return {k: v.to(device or home) for k, v in p.items()}


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, nh, _, n, _ = _dims(cfg)
    gn = N_GROUPS * n
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    b = zxbcdt[..., 2 * d_in:2 * d_in + gn]
    c = zxbcdt[..., 2 * d_in + gn:2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, x, b, c, dt


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} a[..., k]
    below and on the diagonal, -inf above it."""
    ln = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((ln, ln), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_coef, b, c, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan in the reference's blockwise einsum form (the
    `repro.models.ssm.ssd_chunked` ``impl='xla'`` path), an oracle
    independent of the kernel's plan.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus); a_coef: [H] (negative);
    b, c: [B,S,G,N] (G groups broadcast over heads).
    Returns y: [B,S,H,P], final_state: [B,H,P,N] (f32)."""
    bsz, s, nh, p = x.shape
    g, n = b.shape[2], b.shape[3]
    pad = (-s) % chunk
    if pad:
        # zero-pad to a chunk multiple: dt=0 gives decay exp(0)=1 and a
        # zero state contribution, so padded positions are exact no-ops
        zp = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))  # noqa: E731
        y, h_last = ssd_chunked(zp(x), zp(dt), a_coef, zp(b), zp(c),
                                chunk, h0)
        return y[:, :s], h_last
    nc = s // chunk
    rep = nh // g
    xdt = x.float() * dt[..., None]                   # [B,S,H,P]
    da = dt * a_coef[None, None, :]                   # [B,S,H] (negative)

    def r(t, shape):  # chunk reshape [B,S,...] -> [B,nc,chunk,...]
        return t.reshape((bsz, nc, chunk) + shape)

    xc = r(xdt, (nh, p))
    dac = r(da, (nh,)).permute(0, 1, 3, 2)            # [B,nc,H,chunk]
    bc = r(b.float(), (g, n))
    cc = r(c.float(), (g, n))
    bc_h = bc.repeat_interleave(rep, dim=3) if g != nh else bc
    cc_h = cc.repeat_interleave(rep, dim=3) if g != nh else cc

    da_cum = torch.cumsum(dac, dim=-1)                # [B,nc,H,chunk]
    # 1. intra-chunk (quadratic / "attention" form)
    lmat = torch.exp(_segsum(dac))                    # [B,nc,H,chunk,chunk]
    scores = torch.einsum("bclhn,bcshn->bchls", cc_h, bc_h) * lmat
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc)
    # 2. per-chunk output states
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)
    states = torch.einsum("bcshn,bchs,bcshp->bchpn", bc_h, decay_states, xc)
    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(da_cum[..., -1])          # [B,nc,H]
    h = (torch.zeros((bsz, nh, p, n), device=x.device) if h0 is None
         else h0)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, ci][..., None, None] + states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)              # [B,nc,H,P,N]
    # 4. contribution of the carried-in state to each position
    state_decay = torch.exp(da_cum)                    # [B,nc,H,chunk]
    y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", cc_h, h_prevs,
                         state_decay)
    y = (y_diag + y_off).reshape(bsz, s, nh, p)
    return y, h


def ssd_scan(x, dt, a_coef, b, c, chunk: int,
             h0: Optional[torch.Tensor] = None):
    """The model's SSD scan: `kops.ssd_scan` (the kernel on CUDA tensors,
    its plain version on CPU tensors); with grad mode on and an input that
    requires grad, through `SSDScan`, which launches the same kernel and
    gives it a backward. Arguments and results as `ssd_chunked`'s."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a_coef, b, c, h0)):
        return SSDScan.apply(x, dt, a_coef, b, c, h0, int(chunk))
    return kops.ssd_scan(x, dt, a_coef, b, c, chunk, h0)


class SSDScan(torch.autograd.Function):
    """The SSD kernel under autograd (training).

    Forward: `kops.ssd_scan` on the detached inputs, exactly as serving
    calls it. Backward: `ssd_chunked`, the reference's XLA form, recomputed
    under ``torch.enable_grad()`` from the saved inputs, with dY and
    d h_last pulled back through it: the gradient the reference takes (it
    has no backward kernel). ``calls`` and ``backward_calls`` count the
    two directions."""

    calls = 0
    backward_calls = 0

    @staticmethod
    def forward(ctx, x, dt, a_coef, b, c, h0, chunk: int):
        y, h_last = kops.ssd_scan(
            x.detach(), dt.detach(), a_coef.detach(), b.detach(),
            c.detach(), chunk, None if h0 is None else h0.detach())
        ctx.save_for_backward(x, dt, a_coef, b, c, h0)
        ctx.chunk = chunk
        SSDScan.calls += 1
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        SSDScan.backward_calls += 1
        ins = [t if t is None else t.detach().requires_grad_()
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, h_last = ssd_chunked(*ins[:5], ctx.chunk, ins[5])
        grads = iter(torch.autograd.grad(
            (y, h_last), [t for t in ins if t is not None], (dy, dh_last)))
        return (*(None if t is None else next(grads) for t in ins), None)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: [B,S,C]; w: [K,C]. The K products are
    summed in float32 and rounded to xbc's dtype once, then the bias is
    added, as the decode step's einsum does (the reference rounds each
    product and sum in the model dtype; at float32 the two agree)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0)).float()
    wf = w.float()
    out = pad[:, 0:s, :] * wf[0][None, None, :]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * wf[i][None, None, :]
    return out.to(xbc.dtype) + bias[None, None, :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _in_proj(x, p, cfg):
    """in_proj, split; returns (z, xin, b, c, dt, a_coef) with dt the
    post-softplus f32 step sizes and a_coef = -exp(A_log)."""
    cdt = _dtype(cfg.dtype)
    zxbcdt = torch.matmul(x, p["in_proj"].to(cdt))
    z, xin, b, c, dt_raw = _split_proj(zxbcdt, cfg)
    a_coef = -torch.exp(p["A_log"])                    # [H] negative
    dt = _softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    return z, xin, b, c, dt, a_coef


def _full_sequence(x, p, cfg, z, xin, b, c, dt, a_coef):
    """conv -> SSD scan -> gated norm -> out_proj over the whole sequence;
    returns (out, h_last)."""
    cdt = _dtype(cfg.dtype)
    d_in, nh, hp, n, _ = _dims(cfg)
    conv_w = p["conv_w"].to(cdt)
    conv_b = p["conv_b"].to(cdt)
    # the depthwise conv splits exactly into the x part and the B/C part
    xs = F.silu(_causal_conv(xin, conv_w[:, :d_in], conv_b[:d_in]))
    bc_out = F.silu(_causal_conv(torch.cat([b, c], dim=-1),
                                 conv_w[:, d_in:], conv_b[d_in:]))
    bs = bc_out[..., :N_GROUPS * n]
    cs = bc_out[..., N_GROUPS * n:]
    bsz, s = x.shape[0], x.shape[1]
    xh = xs.reshape(bsz, s, nh, hp)
    bg = bs.reshape(bsz, s, N_GROUPS, n)
    cg = cs.reshape(bsz, s, N_GROUPS, n)
    y, h_last = ssd_scan(xh, dt, a_coef, bg, cg, cfg.ssm_chunk)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(bsz, s, d_in).to(cdt)
    y = rms_norm(y * F.silu(z), p["gated_norm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"].to(cdt)), h_last


def ssm_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              cache: Optional[SSMCache] = None
              ) -> tuple[torch.Tensor, Optional[SSMCache]]:
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    Full-sequence when cache is None (returns (out, None)); single-token
    decode otherwise (returns (out, the new cache))."""
    if current_mesh() is not None:
        return _data_parallel(ssm_block, x, p, cfg, cache)
    cdt = _dtype(cfg.dtype)
    d_in, nh, hp, n, _ = _dims(cfg)
    z, xin, b, c, dt, a_coef = _in_proj(x, p, cfg)
    if cache is None:
        out, _ = _full_sequence(x, p, cfg, z, xin, b, c, dt, a_coef)
        return out, None

    # ---- decode ----------------------------------------------------------
    xbc = torch.cat([xin, b, c], dim=-1)               # [B,1,C]
    new_conv = torch.cat([cache.conv, xbc.to(cache.conv.dtype)],
                         dim=1)[:, 1:]                 # [B,K-1,C]
    full = torch.cat([cache.conv.to(cdt), xbc], dim=1)   # [B,K,C]
    conv_out = torch.einsum("bkc,kc->bc", full.float(),
                            p["conv_w"].to(cdt).float()).to(cdt) \
        + p["conv_b"].to(cdt)
    conv_out = F.silu(conv_out)[:, None, :]            # [B,1,C]
    xs = conv_out[..., :d_in]
    bs = conv_out[..., d_in:d_in + N_GROUPS * n]
    cs = conv_out[..., d_in + N_GROUPS * n:]
    bsz = x.shape[0]
    xh = xs.reshape(bsz, nh, hp).float()
    rep = nh // N_GROUPS
    bg = bs.reshape(bsz, N_GROUPS, n).repeat_interleave(rep, dim=1)
    cg = cs.reshape(bsz, N_GROUPS, n).repeat_interleave(rep, dim=1)
    dt1 = dt[:, 0]                                     # [B,H]
    decay = torch.exp(dt1 * a_coef[None, :])           # [B,H]
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh, bg.float())
    h_new = cache.state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, cg.float())
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(bsz, 1, d_in).to(cdt)
    y = rms_norm(y * F.silu(z), p["gated_norm"], cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(cdt))
    return out, SSMCache(new_conv, h_new)


def ssm_prefill_with_cache(x: torch.Tensor, p: dict, cfg: ModelConfig
                           ) -> tuple[torch.Tensor, SSMCache]:
    """Full-sequence forward that also returns the decode cache (serving
    prefill). The conv state is the last K-1 inputs of x|B|C, left-padded
    with zeros when the prompt is shorter (see the module's docstring)."""
    if current_mesh() is not None:
        return _data_parallel(ssm_prefill_with_cache, x, p, cfg)
    cdt = _dtype(cfg.dtype)
    z, xin, b, c, dt, a_coef = _in_proj(x, p, cfg)
    tail = cfg.ssm_conv - 1
    xbc = torch.cat([xin[:, -tail:], b[:, -tail:], c[:, -tail:]], dim=-1)
    if xbc.shape[1] < tail:
        xbc = F.pad(xbc, (0, 0, tail - xbc.shape[1], 0))
    out, h_last = _full_sequence(x, p, cfg, z, xin, b, c, dt, a_coef)
    return out, SSMCache(xbc.to(cdt), h_last)


_CACHE_AXES = SSMCache(conv=("batch", None, "ffn"),
                       state=("batch", "heads", None, None))


def _data_parallel(fn, x, p, cfg: ModelConfig, cache=None):
    """``fn`` (a block on one device) on this rank's rows under a mesh:
    x on the batch axes, the weights whole, the cache on the batch axes;
    the output placed as x and the new cache (if any) on the reference's
    cache axes ([B, ...] leaves, split over the batch as x is)."""
    x = constrain(x, "batch", None, None)
    w = {k: local(constrain(v, *((None,) * v.ndim))) for k, v in p.items()}
    kw = {}
    if fn is ssm_block:
        kw["cache"] = None if cache is None else SSMCache(
            *(local(constrain(t, "batch", *((None,) * (t.ndim - 1))))
              for t in cache))
    with use_sharding(None, SINGLE_DEVICE_RULES):
        out, new = fn(local(x), w, cfg, **kw)
    out = like(out.contiguous(), x, tuple(x.shape[:2]) + (out.shape[-1],))
    if new is None:
        return out, None
    return out, SSMCache(*(
        constrain(like(t.contiguous(), x, (x.shape[0],) + tuple(t.shape[1:])),
                  *axes) for t, axes in zip(new, _CACHE_AXES)))


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device: torch.device) -> SSMCache:
    _, nh, hp, n, conv_dim = _dims(cfg)
    return SSMCache(
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                    dtype=_dtype(cfg.dtype), device=device),
        torch.zeros((batch, nh, hp, n), dtype=torch.float32, device=device))
