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

Under a live mesh (`repro_torch.parallel.axes.use_sharding`) a block is
tensor-parallel over its heads on ``model`` (where the rules put the
heads there and the axis divides them), with the reference's pins: x
and dt over the heads for the SSD scan, B and C whole on every rank, the
conv's x part over ``model``. The sequence is gathered at the block's entry
(training splits it over ``model`` between blocks) and each rank holds
its rows. Two layouts do not align with the heads:
- in_proj is column-parallel over its fused z|x|B|C|dt output (`ffn`),
  so a rank's shard is a contiguous slice of that output, not its heads'
  z, x and dt. One all-to-all over ``model`` regroups the columns (the
  port's transport, `all_to_all_columns`): each rank receives its heads'
  z, x and dt and all of B and C, where the reference gathers the whole
  output.
- the conv weight and the conv cache are split over x|B|C (`ffn`, 4352
  wide), not over the heads. A prefill takes the conv weight whole (K x
  4352) and convolves its heads' x channels and all of B|C (the
  depthwise conv splits exactly), and writes the conv cache's K-1 rows
  on the reference's placement (one all-to-all of those rows). A decode
  step convolves the cache columns a rank holds with its weight shard
  (they align) and regroups the conv outputs as in_proj's.
The SSD kernel runs on the rank's contiguous heads (H / model; one
launch a layer under autograd too, through `SSDScan`), and the state
stays split over the heads [B, H / model, P, N], never moved. The gated
RMSNorm sums its float32 squares over ``model`` (an all-reduce of [B, S,
1]) and scales by the rank's `gated_norm` shard, which aligns with the
heads (d_inner = H P). out_proj is row-parallel: bf16 operands, float32
partial products (`layers.matmul_f32`), summed over ``model`` into the
block input's placement and rounded once. Where ``model`` does not
divide the heads every rank runs all of them on its rows (in_proj's
output gathered whole, the other weights taken whole, the state
replicated over ``model``). Gradients flow through the
transport: a replicated input a rank uses for its own heads or rows
takes the sum of the ranks' parts.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (_dtype, matmul_f32, normal_init,
                                       rms_norm)
from repro_torch.parallel.axes import (all_to_all_columns, axis_size,
                                       constrain, current_mesh, from_local,
                                       is_dtensor, local, redistribute,
                                       sanitized_spec, spec_placements)

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
        return _mesh_block(x, p, cfg, cache=cache)
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
        return _mesh_block(x, p, cfg, with_cache=True)
    cdt = _dtype(cfg.dtype)
    z, xin, b, c, dt, a_coef = _in_proj(x, p, cfg)
    tail = cfg.ssm_conv - 1
    xbc = torch.cat([xin[:, -tail:], b[:, -tail:], c[:, -tail:]], dim=-1)
    if xbc.shape[1] < tail:
        xbc = F.pad(xbc, (0, 0, tail - xbc.shape[1], 0))
    out, h_last = _full_sequence(x, p, cfg, z, xin, b, c, dt, a_coef)
    return out, SSMCache(xbc.to(cdt), h_last)


# ---------------------------------------------------------------------------
# tensor parallelism under a live mesh
# ---------------------------------------------------------------------------

class _Plan(NamedTuple):
    """A rank's part of the tensor-parallel block."""

    m: int               # ranks of the model axis (1 without one)
    r: int               # this rank's index on it
    tp: int              # ranks the heads are split over (1 or m)
    partial: frozenset   # mesh axes over which a replicated input's
    #                      gradient is a sum of the ranks' parts

    def heads(self, j: int, nh: int) -> tuple[int, int]:
        """Rank j's heads [h0, h1)."""
        k = nh // self.tp
        return (j * k, (j + 1) * k) if self.tp > 1 else (0, nh)


def _plan(xr, cfg: ModelConfig) -> _Plan:
    """The heads go over ``model`` where the rules put them there and the
    axis divides them (else every rank takes all heads). A replicated
    input's gradient is a partial sum over the axes that split the rows,
    and over ``model`` when the heads are split: there each rank's part
    is its own rows' and heads' contribution."""
    mesh = xr.device_mesh
    m = axis_size("model")
    tp = m if sanitized_spec((cfg.ssm_heads,), ("heads",))[0] == "model" \
        else 1
    rows = {a for a, pl in zip(mesh.mesh_dim_names, xr.placements)
            if pl.is_shard(0)}
    return _Plan(m, mesh.get_local_rank("model") if m > 1 else 0, tp,
                 frozenset(rows | ({"model"} if tp > 1 else set())))


def _mine(d, partial, moved: bool = True) -> torch.Tensor:
    """The rank's shard of DTensor ``d``, whose gradient is a partial sum
    over the mesh axes in ``partial`` where ``d`` is replicated (a rank's
    computation from it is its own part). ``moved``: ``d`` came from the
    port's transport, whose backward sums those parts as it moves them
    back; otherwise they are summed here (an all-reduce)."""
    from torch.distributed.tensor import Partial

    mesh = d.device_mesh
    grad = tuple(Partial() if pl.is_replicate() and a in partial
                 and mesh.size(i) > 1 else pl
                 for i, (a, pl) in enumerate(zip(mesh.mesh_dim_names,
                                                 d.placements)))
    if not moved and grad != tuple(d.placements) and d.requires_grad \
            and torch.is_grad_enabled():
        d = _SumParts.apply(d)
    return d.to_local(grad_placements=grad)


class _SumParts(torch.autograd.Function):
    """The identity, whose backward sums the ranks' partial gradients by
    the port's transport, back to the input's placements."""

    @staticmethod
    def forward(ctx, d):
        ctx.placements = tuple(d.placements)
        return d.view_as(d)

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.placements)


def _moved(t, d) -> bool:
    """Whether `constrain` moved ``t`` to ``d`` (a plain tensor counts as
    replicated)."""
    from torch.distributed.tensor import Replicate

    src = tuple(t.placements) if is_dtensor(t) else \
        (Replicate(),) * d.device_mesh.ndim
    return src != tuple(d.placements)


def _merge(ranges) -> list:
    """Column ranges [a, b), sorted and merged where they meet."""
    out: list = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _cols(t, have, a: int, b: int) -> torch.Tensor:
    """Global columns [a, b) of ``t``, which holds the column ranges
    ``have`` side by side."""
    at = 0
    for lo, hi in have:
        if lo <= a and b <= hi:
            return t[..., at + a - lo:at + b - lo]
        at += hi - lo
    raise ValueError(f"columns [{a}, {b}) are not among {have}")


def _mesh_block(x, p: dict, cfg: ModelConfig, *,
                cache: Optional[SSMCache] = None, with_cache: bool = False):
    """`ssm_block` (``cache``: one decode step) or `ssm_prefill_with_cache`
    (``with_cache``) under a live mesh, tensor-parallel over the heads
    (see the module's docstring). Returns (out placed as ``x``, the new
    cache on the reference's cache axes, or None)."""
    from torch.distributed.tensor import Shard

    cdt = _dtype(cfg.dtype)
    d_in, nh, hp, n, conv_dim = _dims(cfg)
    gn = N_GROUPS * n
    xr = constrain(x, "batch", None, None)      # the sequence gathered
    mesh = xr.device_mesh
    pl = _plan(xr, cfg)
    xl = _mine(xr, pl.partial & {"model"}, _moved(x, xr))
    bsz, s = xl.shape[:2]

    def w(name, *axes):
        d = constrain(p[name], *axes)
        return _mine(d, pl.partial, _moved(p[name], d))

    # the conv cache's x|B|C columns over `model`: rank j's [j kc, j kc
    # + kc) (all of them where the axis does not divide them)
    kc = local(cache.conv).shape[2] if cache is not None else \
        conv_dim // (pl.m if sanitized_spec((conv_dim,), ("ffn",))[0]
                     == "model" else 1)

    def conv_cols(j):
        return (j * kc, (j + 1) * kc) if kc < conv_dim else (0, conv_dim)

    def need(j):
        """The z|x|B|C|dt columns rank j takes: its heads' z, x and dt,
        all of B and C, and in decode its conv cache's columns."""
        h0, h1 = pl.heads(j, nh)
        ranges = [(h0 * hp, h1 * hp), (d_in + h0 * hp, d_in + h1 * hp),
                  (2 * d_in, 2 * d_in + 2 * gn),
                  (2 * d_in + 2 * gn + h0, 2 * d_in + 2 * gn + h1)]
        if cache is not None:
            ranges.append(tuple(d_in + c for c in conv_cols(j)))
        return _merge(ranges)

    # in_proj column-parallel where its output splits evenly; its fused
    # z|x|B|C|dt shard is not the rank's heads, so the columns are
    # regrouped by one all-to-all (B and C to every rank)
    zx_r = torch.matmul(xl, w("in_proj", None, "ffn").to(cdt))
    d_proj = p["in_proj"].shape[-1]
    split = zx_r.shape[-1] != d_proj
    if split:
        want = [need(j) for j in range(pl.m)]
        zx, have = all_to_all_columns(zx_r, "model", want), want[pl.r]
    else:
        zx, have = zx_r, [(0, d_proj)]
    h0, h1 = pl.heads(pl.r, nh)
    c0, c1 = h0 * hp, h1 * hp
    z = _cols(zx, have, c0, c1)
    dt_raw = _cols(zx, have, 2 * d_in + 2 * gn + h0, 2 * d_in + 2 * gn + h1)
    a_coef = -torch.exp(w("A_log", None)[h0:h1])
    dt = _softplus(dt_raw.float() + w("dt_bias", None)[h0:h1][None, None, :])
    d_skip = w("D", None)[h0:h1]

    new = None
    if cache is None:
        # the conv weight's `ffn` shard is a quarter of x|B|C, not the
        # rank's heads: taken whole (K x conv_dim); the depthwise conv
        # splits exactly into the rank's x channels and all of B|C
        conv_w = w("conv_w", None, None).to(cdt)
        conv_b = w("conv_b", None).to(cdt)
        xs = F.silu(_causal_conv(_cols(zx, have, d_in + c0, d_in + c1),
                                 conv_w[:, c0:c1], conv_b[c0:c1]))
        bc = F.silu(_causal_conv(_cols(zx, have, 2 * d_in, 2 * d_in + 2 * gn),
                                 conv_w[:, d_in:], conv_b[d_in:]))
        xh = xs.reshape(bsz, s, -1, hp).contiguous()
        y, h_last = ssd_scan(
            xh, dt.contiguous(), a_coef.contiguous(),
            bc[..., :gn].reshape(bsz, s, N_GROUPS, n).contiguous(),
            bc[..., gn:].reshape(bsz, s, N_GROUPS, n).contiguous(),
            cfg.ssm_chunk)
        y = y + xh.float() * d_skip[None, None, :, None]
        if with_cache:
            # the last K-1 inputs of x|B|C, each rank its conv cache's
            # columns (one all-to-all of K-1 rows)
            tail = cfg.ssm_conv - 1
            rows = zx_r[:, -tail:].contiguous()
            if split:
                rows = all_to_all_columns(rows, "model", [
                    [tuple(d_in + c for c in conv_cols(j))]
                    for j in range(pl.m)])
            else:
                a, b = conv_cols(pl.r)
                rows = rows[..., d_in + a:d_in + b]
            if rows.shape[1] < tail:
                rows = F.pad(rows, (0, 0, tail - rows.shape[1], 0))
            shape = (xr.shape[0], tail, conv_dim)
            new = (from_local(rows.to(cdt).contiguous(), mesh,
                              spec_placements(sanitized_spec(
                                  shape, ("batch", None, "ffn")), mesh),
                              shape), h_last)
    else:
        y, new = _mesh_decode(zx, have, cache, p, cfg, pl, (c0, c1),
                              conv_cols, dt, a_coef, d_skip)
    if new is not None:
        conv, h = new
        state_pl = tuple(Shard(1) if a == "model" and pl.tp > 1 else q
                         for a, q in zip(mesh.mesh_dim_names, xr.placements))
        new = SSMCache(conv, from_local(h.contiguous(), mesh, state_pl,
                                        (xr.shape[0], nh, hp, n)))
    y = y.reshape(bsz, s, -1).to(cdt)
    return _mesh_out(y * F.silu(z), x, xr, cfg, pl, w), new


def _mesh_decode(zx, have, cache: SSMCache, p: dict, cfg: ModelConfig,
                 pl: _Plan, cols: tuple, conv_cols, dt, a_coef, d_skip):
    """One decode step of the rank's heads (x channels ``cols``). The conv
    cache stays on the reference's axes (x|B|C over ``ffn``, which do not
    align with the heads): each rank convolves the columns it holds (its
    `conv_w` shard holds the same ones), and one all-to-all hands every
    rank its heads' x channels and all of B|C. The state is the rank's
    heads [B, H/model, P, N] and never moves. Returns (y [B, 1, H/model,
    P] float32, (the new conv cache DTensor, the rank's new state))."""
    cdt = _dtype(cfg.dtype)
    d_in, nh, hp, n, conv_dim = _dims(cfg)
    gn = N_GROUPS * n
    conv = cache.conv
    cl = local(conv)
    a, b = conv_cols(pl.r)
    xbc = _cols(zx, have, d_in + a, d_in + b)                # [B,1,kc]
    w_c = local(constrain(p["conv_w"], None, "ffn"))
    b_c = local(constrain(p["conv_b"], "ffn"))
    if w_c.shape[1] != b - a:                # not split as the cache is
        w_c = local(constrain(p["conv_w"], None, None))[:, a:b]
        b_c = local(constrain(p["conv_b"], None))[a:b]
    full = torch.cat([cl.to(cdt), xbc], dim=1)              # [B,K,kc]
    co = torch.einsum("bkc,kc->bc", full.float(),
                      w_c.to(cdt).float()).to(cdt) + b_c.to(cdt)
    co = F.silu(co)[:, None, :].contiguous()
    new_conv = torch.cat([cl, xbc.to(cl.dtype)], dim=1)[:, 1:]
    if b - a < conv_dim:
        want = [_merge([tuple(c * hp for c in pl.heads(j, nh)),
                        (d_in, d_in + 2 * gn)]) for j in range(pl.m)]
        co, have_c = all_to_all_columns(co, "model", want), want[pl.r]
    else:
        have_c = [(0, conv_dim)]
    bsz = co.shape[0]
    xh = _cols(co, have_c, *cols).reshape(bsz, -1, hp).float()
    rep = xh.shape[1] // N_GROUPS
    bg = _cols(co, have_c, d_in, d_in + gn).reshape(bsz, N_GROUPS, n) \
        .repeat_interleave(rep, dim=1)
    cg = _cols(co, have_c, d_in + gn, d_in + 2 * gn) \
        .reshape(bsz, N_GROUPS, n).repeat_interleave(rep, dim=1)
    dt1 = dt[:, 0]                                          # [B,H/model]
    decay = torch.exp(dt1 * a_coef[None, :])
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh, bg.float())
    h_new = local(cache.state) * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, cg.float())
    y = y + xh * d_skip[None, :, None]
    new_conv = from_local(new_conv.contiguous(), conv.device_mesh,
                          conv.placements, tuple(conv.shape))
    return y[:, None], (new_conv, h_new)


def _mesh_out(g, x, xr, cfg: ModelConfig, pl: _Plan, w):
    """The gated RMSNorm over all of d_inner and the row-parallel
    out_proj, from the rank's gated columns g [B, S, d_inner / tp]: the
    float32 sum of squares summed over ``model`` (an all-reduce of [B, S,
    1]), the rank's `gated_norm` shard (it aligns with the heads: d_inner
    = H P); bf16 operands with float32 partial products, summed over
    ``model`` and rounded once, placed as the block's input ``x``."""
    from torch.distributed.tensor import Partial

    cdt = _dtype(cfg.dtype)
    split = pl.tp > 1
    mesh = xr.device_mesh
    summed = tuple(Partial() if a == "model" and split else q
                   for a, q in zip(mesh.mesh_dim_names, xr.placements))
    gf = g.float()
    ss = (gf * gf).sum(dim=-1, keepdim=True)
    if split:
        ss = _mine(redistribute(from_local(
            ss, mesh, summed, tuple(xr.shape[:2]) + (1,)), xr.placements),
            pl.partial & {"model"})
    scale = w("gated_norm", "ffn" if split else None)
    y = (gf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
         * scale.float()).to(cdt)
    wo = w("out_proj", "ffn" if split else None, None).to(cdt)
    if not split:
        out = torch.matmul(y, wo)
    elif torch.is_grad_enabled() and (y.requires_grad or wo.requires_grad):
        out = torch.matmul(y.float(), wo.float())
    else:
        out = matmul_f32(y, wo)
    out = from_local(out, mesh, summed,
                     tuple(xr.shape[:2]) + (out.shape[-1],))
    return redistribute(out, x.placements if is_dtensor(x)
                        else xr.placements).to(cdt)


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device: torch.device) -> SSMCache:
    _, nh, hp, n, conv_dim = _dims(cfg)
    return SSMCache(
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                    dtype=_dtype(cfg.dtype), device=device),
        torch.zeros((batch, nh, hp, n), dtype=torch.float32, device=device))
