"""The plain versions of the port's two attention kernels against the JAX
reference on the same numpy inputs: the reference's Pallas kernels in
interpret mode (`repro.kernels.ops`, as `tests/test_kernels.py` runs
them), its dense oracles (`repro.kernels.ref.attention_ref` and
`decode_attention_ref`) and its model's blockwise XLA attention
(`attn_impl="xla"`). Everything runs on the CPU, where the kernel
wrappers run their plain versions; the CUDA kernels are held against the
same plain versions in `tests/test_torch_gpu.py` and `chip_smoke.py`.

Tolerances (the reference's own): atol = rtol = 2e-5 at float32 (the
paths differ in the order of float32 sums), 2e-2 at bfloat16 (p is
rounded to bf16 before p.v on the kernels' side, after normalisation on
the dense oracles' side). Rows whose keys are all masked are compared
for finiteness only: with the finite NEG_INF their output depends on
which tiles a path visits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.inputs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)

# B, Sq, Skv, H, G, D, causal, window, q_offset: the reference's
# FLASH_CASES (tests/test_kernels.py), then grouped 8:1 heads in two
# groups (the serving config's ratio) and a query tile past 64 rows
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 100, 100, 8, 2, 64, True, 0, 0),
    (2, 64, 256, 4, 4, 32, False, 0, 0),
    (1, 128, 128, 4, 1, 64, True, 32, 0),
    (1, 16, 144, 4, 2, 64, True, 0, 128),
    (1, 128, 128, 4, 2, 64, True, 100, 0),
    (2, 96, 96, 6, 3, 128, True, 0, 0),
    (1, 130, 130, 16, 2, 16, True, 0, 0),
    (1, 70, 200, 16, 2, 32, True, 40, 130),
]

# B, H, G, D, W: the reference's DECODE_CASES, then 8:1 heads in two
# groups over a cache that is not a multiple of the tile
DECODE_CASES = [
    (2, 8, 2, 64, 100),
    (1, 4, 4, 32, 256),
    (3, 16, 2, 128, 77),
    (1, 4, 1, 64, 513),
    (2, 16, 2, 16, 200),
]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(x, dtype="float32"):
    """The same numpy array as a JAX array and a torch tensor."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_reference(case):
    b, sq, skv, h, g, d, causal, win, qo = case
    rng = np.random.default_rng(sum(case))
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, b, n, heads, d))
        for n, heads in ((sq, h), (skv, g), (skv, g)))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=win,
                              q_offset=qo, bq=32, bkv=32)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=win,
                                  q_offset=qo, bq=32, bkv=32)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal, window=win,
                                q_offset=qo)
    mine = ref.attention_ref(tq, tk, tv, causal=causal, window=win,
                             q_offset=qo)
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    for want in (pallas, oracle, mine):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("case", [(1, 64, 64, 4, 4, 64, 0, 0),
                                  (1, 96, 96, 16, 2, 128, 0, 0),
                                  (2, 80, 80, 8, 2, 32, 24, 0)])
def test_flash_plain_bf16(case):
    """bf16 in and out, against the reference's interpret-mode kernel at
    bf16 and its float32 oracle."""
    b, sq, skv, h, g, d, win, qo = case
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, b, n, heads, d), "bfloat16")
        for n, heads in ((sq, h), (skv, g), (skv, g)))
    got = flash_attention(tq, tk, tv, causal=True, window=win, q_offset=qo)
    assert got.dtype == torch.bfloat16
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=win,
                                  q_offset=qo, bq=32, bkv=32)
    oracle = jref.attention_ref(jq.astype(jnp.float32),
                                jk.astype(jnp.float32),
                                jv.astype(jnp.float32), causal=True,
                                window=win, q_offset=qo)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_plain_bf16_head_dims(dh):
    """bf16 in and out at each head dim the kernels take, with a ragged Sq
    (100 rows: a query tile of 36) at GQA 2:1, against the reference's
    interpret-mode kernel at bf16 and its float32 oracle: the plain
    version mirrors the tensor-core kernel, which takes bf16 at every Dh."""
    rng = np.random.default_rng(dh)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, 1, 100, heads, dh), "bfloat16")
        for heads in (4, 2, 2))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 100, 4, dh)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, bq=32, bkv=32)
    oracle = jref.attention_ref(jq.astype(jnp.float32),
                                jk.astype(jnp.float32),
                                jv.astype(jnp.float32), causal=True)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("chunks", [(16, 32), (8, 16)])
def test_flash_plain_matches_model_blockwise(chunks):
    """The port's plain flash == the reference model's XLA blockwise
    attention at GQA 8:1 in two groups (the reference's chunk sizes do not
    change the port's tiles)."""
    qc, kc = chunks
    cfg = jax_reduced(jax_get_config("qwen1.5-0.5b")).replace(
        attn_q_chunk=qc, attn_kv_chunk=kc)
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, 2, 96, heads, 16)) for heads in (16, 2, 2))
    want = jattn.blockwise_attention(jq, jk, jv, cfg, causal=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, bq=qc, bkv=kc)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_plain_head_order_is_grouped():
    """Head h reads KV group h // (H // G): zeroing group 1's values
    zeroes exactly heads 8..15 at H = 16, G = 2."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(_normal(rng, 1, 40, 16, 16))
    k = torch.as_tensor(_normal(rng, 1, 40, 2, 16))
    v = torch.as_tensor(_normal(rng, 1, 40, 2, 16))
    v[:, :, 1] = 0.0
    out = flash_attention(q, k, v, causal=True)
    assert torch.all(out[:, :, 8:] == 0)
    assert torch.all(out[:, :, :8].abs().sum(-1) > 0)
    qd = q[:, -1:].contiguous()
    outd = decode_attention(qd, k, v, torch.ones((1, 40), dtype=torch.int8))
    assert torch.all(outd[:, :, 8:] == 0)
    assert torch.all(outd[:, :, :8].abs().sum(-1) > 0)


def test_flash_fully_masked_rows_are_finite():
    """Rows whose window excludes every key must not produce NaNs (the
    reference's `test_flash_fully_masked_rows_are_finite`), and rows with
    at least one key agree with the oracle whatever the tiles visited."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(_normal(rng, 1, 32, 2, 16)) for _ in range(3))
    out = flash_attention(q, k, v, causal=True, window=4, q_offset=1000)
    assert bool(torch.isfinite(out).all())
    # 80 queries at positions 40..119 against 70 keys, window 4: rows
    # 0..32 see a key, rows 33..79 see none
    q2 = torch.as_tensor(_normal(rng, 1, 80, 2, 16))
    k2, v2 = (torch.as_tensor(_normal(rng, 1, 70, 2, 16)) for _ in range(2))
    out2 = flash_attention(q2, k2, v2, causal=True, window=4, q_offset=40)
    want2 = ref.attention_ref(q2, k2, v2, causal=True, window=4,
                              q_offset=40)
    seen = torch.arange(80) + 40 - 3 < 70         # a key in (pos - 4, pos]
    assert int(seen.sum()) == 33
    assert bool(torch.isfinite(out2).all())
    np.testing.assert_allclose(_np(out2[:, seen]), _np(want2[:, seen]),
                               **F32)


def _valid(rng, b, w, kind):
    if kind == "random":
        valid = rng.random((b, w)) > 0.3
        valid[:, 0] = True                # never fully masked
        return valid
    # a rolling cache of window w after pos tokens: slot s holds
    # position pos - ((pos - s) % w); every slot valid once pos >= w - 1,
    # and the wrapped slots hold the newest positions
    pos = np.arange(b) * 37 + w // 2
    pos_buf = pos[:, None] - ((pos[:, None] - np.arange(w)[None]) % w)
    return (pos_buf >= 0) & (pos_buf <= pos[:, None]) \
        & (pos_buf > pos[:, None] - w + 5)


@pytest.mark.parametrize("kind", ["random", "rolling"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_reference(case, kind):
    b, h, g, d, w = case
    rng = np.random.default_rng(sum(case))
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, b, n, heads, d))
        for n, heads in ((1, h), (w, g), (w, g)))
    valid = _valid(rng, b, w, kind)
    jvalid, tvalid = jnp.asarray(valid), torch.as_tensor(valid)
    got = ops.decode_attention(tq, tk, tv, tvalid, bkv=32)
    pallas = jops.decode_attention(jq, jk, jv, jvalid, bkv=32)
    oracle = jref.decode_attention_ref(jq, jk, jv, jvalid)
    mine = ref.decode_attention_ref(tq, tk, tv, tvalid)
    model_xla = jattn._decode_attention(jq, jk, jv, jvalid, None)
    assert got.shape == (b, 1, h, d)
    for want in (pallas, oracle, mine, model_xla):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_decode_plain_bf16_and_masked_rows():
    """bf16 at the serving ratio (R = 8, G = 2), and a row with no valid
    slot stays finite."""
    rng = np.random.default_rng(9)
    b, h, g, d, w = 3, 16, 2, 128, 150
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, b, n, heads, d), "bfloat16")
        for n, heads in ((1, h), (w, g), (w, g)))
    valid = _valid(rng, b, w, "random")
    got = decode_attention(tq, tk, tv, torch.as_tensor(valid).to(torch.int8))
    assert got.dtype == torch.bfloat16
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), bkv=64)
    oracle = jref.decode_attention_ref(jq.astype(jnp.float32),
                                       jk.astype(jnp.float32),
                                       jv.astype(jnp.float32),
                                       jnp.asarray(valid))
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **BF16)
    valid[1] = False
    out = decode_attention(tq, tk, tv, torch.as_tensor(valid).to(torch.int8))
    assert bool(torch.isfinite(out.float()).all())
    np.testing.assert_allclose(_np(out[[0, 2]]), _np(got[[0, 2]]), **BF16)


# B, H, G, D, W and the valid slots of each row as [start, stop) ranges:
# a linear cache filled to a few lengths (whole tiles and splits past the
# fill hold no valid slot), a window late in the cache (the first tiles
# are empty, the row's first valid tile comes after them), and a cache of
# five 256-slot splits (DECODE_SPLIT) whose rows leave the first two, or
# the last four, splits without a valid slot
SPARSE_DECODE_CASES = [
    (4, 16, 2, 32, 600, [(0, 1), (0, 65), (0, 300), (0, 600)]),
    (2, 8, 2, 64, 700, [(300, 420), (513, 700)]),
    (3, 16, 2, 64, 1100, [(0, 100), (600, 1100), (0, 1100)]),
]


@pytest.mark.parametrize("case", SPARSE_DECODE_CASES)
def test_decode_plain_skips_tiles_with_no_valid_slot(case):
    """The plain decode version skips a 64-slot tile with no valid slot,
    as the kernel does; rows with a valid slot still match the reference,
    and a row with none comes out exactly 0."""
    b, h, g, d, w, spans = case
    rng = np.random.default_rng(w)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, b, n, heads, d))
        for n, heads in ((1, h), (w, g), (w, g)))
    valid = np.zeros((b, w), bool)
    for row, (lo, hi) in enumerate(spans):
        valid[row, lo:hi] = True
    got = ops.decode_attention(tq, tk, tv, torch.as_tensor(valid))
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), bkv=64)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid))
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    valid[0] = False
    none = ops.decode_attention(tq, tk, tv, torch.as_tensor(valid))
    assert bool((none[0] == 0).all())
    np.testing.assert_allclose(_np(none[1:]), _np(got[1:]), **F32)


def test_wrappers_route_by_device():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing; asking for the kernel on CPU tensors raises."""
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 8, 2, 16))
    n_flash, n_dec = flash_attention.launches, decode_attention.launches
    flash_attention(q, k, k)
    decode_attention(q[:, :1], k, k, torch.ones((1, 8), dtype=torch.int8))
    assert (flash_attention.launches, decode_attention.launches) == \
        (n_flash, n_dec)
    with pytest.raises(ValueError, match="use_kernel"):
        flash_attention(q, k, k, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel"):
        decode_attention(q[:, :1], k, k, torch.ones((1, 8), dtype=torch.int8),
                         use_kernel=True)


def test_decode_ticket_counters_are_per_stream_and_grow_as_zeros():
    """The decode kernel's ticket counters: one zeroed int32 buffer per
    (device, stream), reused while it is large enough and replaced by a
    larger zeroed one when a call has more (batch row, group) pairs. The
    buffer logic is plain torch, checked here on CPU tensors with stand-in
    stream handles; the kernel that uses them is checked on the card."""
    from repro_torch.kernels import decode_attention as dmod

    cpu = torch.device("cpu")
    keys = [(cpu.index, s) for s in (-1, -2)]
    try:
        a = dmod._ticket_counters(cpu, -1, 4)
        assert a.dtype == torch.int32 and a.numel() == 4
        assert dmod._ticket_counters(cpu, -1, 3) is a
        b = dmod._ticket_counters(cpu, -2, 4)
        assert b is not a
        a[:] = 7                              # not copied into the new one
        grown = dmod._ticket_counters(cpu, -1, 5)
        assert grown.numel() == 8 and int(grown.count_nonzero()) == 0
        assert dmod._ticket_counters(cpu, -1, 20).numel() == 20
    finally:
        for k in keys:
            dmod._counters.pop(k, None)
