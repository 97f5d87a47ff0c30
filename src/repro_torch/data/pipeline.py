"""Deterministic synthetic-token data pipeline (mirrors
`repro.data.pipeline`).

The pipeline is *stateless by step index*: ``batch_at(step)`` is a pure
function of (seed, step), so a job restored from a step-``s`` checkpoint
resumes with exactly the batch it would have seen, which bit-identical
pause and resume rely on.

Documents are drawn from a power-law token distribution, cut into
geometric-length documents and packed; ``loss_mask`` zeroes the
prediction of the token right after each boundary.

The reference draws its uniforms from `jax.random`, which torch cannot
reproduce, so `batch_at` is split as `repro_torch.energy.markets` splits
its draws: `batch_draws` takes two uniform [B, S+1] blocks from a CPU
`torch.Generator` seeded from (seed, step) and copies them to the device,
so that every device gets the same batch; `shape_batch` is the
deterministic shaping (the Pareto tail, the separators, the mask), which
parity tests feed the reference's uniforms. The Pareto power runs in
float64 and is rounded to float32: XLA's float32 power and PyTorch's
differ in the last place at some arguments (and the card's from the
CPU's), and the cast to a token id turns such a difference into another
token where it crosses an integer; rounded from float64, the powers land
on the reference's token ids.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic LM corpus (packed documents)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    zipf_a: float = 1.2            # token power-law exponent

    def batch_at(self, step: int, *, device: DeviceLike = None) -> dict:
        return batch_at(self, step, device=device)


def batch_draws(ds: SyntheticLM, step: int, *, device: DeviceLike = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two uniform [global_batch, seq_len + 1] float32 blocks of
    ``step``: the token draws in [1e-6, 1) and the boundary draws in
    [0, 1), from a CPU generator seeded from (seed, step), on ``device``."""
    dev = resolve_device(device)
    seed = np.random.SeedSequence([int(ds.seed), int(step)])
    g = torch.Generator().manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))
    shape = (ds.global_batch, ds.seq_len + 1)
    lo = torch.tensor(1e-6, dtype=torch.float32)
    u_tok = torch.clamp(torch.rand(shape, generator=g) * (1.0 - lo) + lo,
                        min=lo)
    u_cut = torch.rand(shape, generator=g)
    return u_tok.to(dev), u_cut.to(dev)


def _zipf_tokens(u: torch.Tensor, vocab: int, a: float) -> torch.Tensor:
    """Power-law token ids in [2, vocab) from uniforms u in [1e-6, 1):
    id = 2 + floor(z), z = u^(-1/(a-1)) - 1 (a Pareto tail), bounded."""
    hi = float(vocab - 2)
    expo = float(np.float32(-1.0 / (a - 1.0)))      # the reference's float32
    z = torch.pow(u.double(), expo).float() - 1.0
    z = torch.clamp(z, max=hi - 1.0)
    return (2.0 + z).to(torch.int32)


def shape_batch(ds: SyntheticLM, u_tok: torch.Tensor,
                u_cut: torch.Tensor) -> dict:
    """The batch from its draws: {tokens, labels, loss_mask}, on the
    draws' device. tokens/labels: [B, S] int32, labels the next tokens of
    the packed stream; token 1 is the document separator; loss_mask [B, S]
    float32 is 0 where the label follows a boundary."""
    toks = _zipf_tokens(u_tok, ds.vocab, ds.zipf_a)
    cut = u_cut < (1.0 / ds.mean_doc_len)
    toks = torch.where(cut, torch.ones_like(toks), toks)   # sep token = 1
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "loss_mask": 1.0 - cut[:, 1:].to(torch.float32)}


def batch_at(ds: SyntheticLM, step: int, *, device: DeviceLike = None,
             draws: Optional[tuple] = None) -> dict:
    """The global batch for ``step`` on ``device`` (default cuda):
    {tokens, labels, loss_mask}. ``draws`` (u_tok, u_cut) replaces
    `batch_draws` (parity tests inject the reference's)."""
    dev = resolve_device(device)
    if draws is None:
        draws = batch_draws(ds, step, device=dev)
    u_tok, u_cut = (torch.as_tensor(d, dtype=torch.float32).to(dev)
                    for d in draws)
    return shape_batch(ds, u_tok, u_cut)


def host_shard(batch: dict, host_index: int, n_hosts: int) -> dict:
    """The slice of the global batch this host feeds (each host
    materialises only its rows)."""
    def f(x):
        per = x.shape[0] // n_hosts
        return x[host_index * per:(host_index + 1) * per]
    return {k: f(v) for k, v in batch.items()}


def global_batch_sharding(mesh, rules):
    """The `NamedSharding` of batch trees ([B, S] leaves) under ``rules``
    on ``mesh``: rows over the batch axes."""
    from repro_torch.parallel.axes import named_sharding
    return named_sharding("batch", None, mesh=mesh, rules=rules)


def to_numpy(batch: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in batch.items()}
