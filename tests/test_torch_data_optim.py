"""The port's data pipeline, learning-rate schedules, int8 gradient
compression and analytic FLOP counts against the JAX reference, on the
CPU. All of these match exactly: the pipeline with the reference's
uniforms injected (the tokens, labels and mask), the schedules bit for
bit, quantise / de-quantise bit for bit, the counts as Python numbers."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.configs import base, inputs  # noqa: E402
from repro_torch.data import (SyntheticLM, batch_at,  # noqa: E402
                              global_batch_sharding, host_shard)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.optim import (compressed_pmean, constant,  # noqa: E402
                               dequantize, init_error_feedback,
                               quantize_int8, warmup_cosine)
from repro_torch.optim.compress import compressed_pmean_leaf  # noqa: E402

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

def _reference_draws(ds, step):
    """The reference's two uniform blocks (`repro.data.pipeline.batch_at`'s
    keys and calls)."""
    key = jax.random.fold_in(jax.random.PRNGKey(ds.seed), step)
    k_tok, k_cut = jax.random.split(key)
    shape = (ds.global_batch, ds.seq_len + 1)
    return (np.array(jax.random.uniform(k_tok, shape, minval=1e-6,
                                          maxval=1.0)),
            np.array(jax.random.uniform(k_cut, shape)))


@pytest.mark.parametrize("spec", [(151936, 1024, 8, 0, 3),
                                  (256, 16, 2, 5, 0),
                                  (32000, 300, 4, 1, 17)])
def test_batch_with_the_reference_draws_is_the_reference_batch(spec):
    """qwen's vocab at the full-width run's 8 x 1024, a reduced one and
    an odd one: tokens, labels and mask exactly."""
    vocab, s, b, seed, step = spec
    jds = jpipe.SyntheticLM(vocab=vocab, seq_len=s, global_batch=b,
                            seed=seed, mean_doc_len=64)
    want = jpipe.batch_at(jds, step)
    ds = SyntheticLM(vocab=vocab, seq_len=s, global_batch=b, seed=seed,
                     mean_doc_len=64)
    got = batch_at(ds, step, device=CPU, draws=_reference_draws(jds, step))
    assert got["tokens"].dtype == torch.int32
    assert got["loss_mask"].dtype == torch.float32
    for k in ("tokens", "labels", "loss_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["tokens"].min()) >= 1 and int(got["tokens"].max()) < vocab


def test_batch_is_stateless_by_step_and_differs_across_steps():
    ds = SyntheticLM(vocab=1000, seq_len=64, global_batch=4, seed=3)
    a = ds.batch_at(7, device=CPU)
    ds.batch_at(8, device=CPU)
    again = ds.batch_at(7, device="cpu")
    other = ds.batch_at(8, device=CPU)
    for k in a:
        assert torch.equal(a[k], again[k]), k
    assert not torch.equal(a["tokens"], other["tokens"])
    reseeded = SyntheticLM(vocab=1000, seq_len=64, global_batch=4, seed=4)
    assert not torch.equal(a["tokens"],
                           reseeded.batch_at(7, device=CPU)["tokens"])
    # labels are the next tokens of the packed stream; separators unmasked
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    sep = a["labels"] == 1
    assert torch.equal(a["loss_mask"] == 0, sep)


def test_batch_draws_come_from_the_cpu_generator():
    """The draws are the CPU generator's whatever the device, so the
    batch on any device is the CPU batch (the card is checked in
    tests/test_torch_gpu.py)."""
    ds = SyntheticLM(vocab=500, seq_len=32, global_batch=2, seed=9)
    u_tok, u_cut = pipeline.batch_draws(ds, 4, device=CPU)
    assert u_tok.shape == u_cut.shape == (2, 33)
    assert float(u_tok.min()) >= 1e-6 and float(u_tok.max()) < 1.0
    assert float(u_cut.min()) >= 0.0 and float(u_cut.max()) < 1.0
    got = batch_at(ds, 4, device=CPU, draws=(u_tok, u_cut))
    want = batch_at(ds, 4, device=CPU)
    for k in want:
        assert torch.equal(got[k], want[k])


def test_host_shard_partitions_the_batch():
    ds = SyntheticLM(vocab=300, seq_len=8, global_batch=8, seed=1)
    batch = ds.batch_at(0, device=CPU)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    shards = [host_shard(batch, i, 4) for i in range(4)]
    for k in batch:
        assert torch.equal(torch.cat([s[k] for s in shards]), batch[k])
        for i, s in enumerate(shards):
            np.testing.assert_array_equal(
                s[k].numpy(), np.asarray(jpipe.host_shard(jbatch, i, 4)[k]))
    # the batch sharding on a (pod, data, model) mesh: rows over pod and
    # data, as the reference's on a one-device mesh of the same axes
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 2, 2))
    jmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    from repro.parallel.axes import TRAIN_RULES as JRULES
    from repro_torch.parallel.axes import TRAIN_RULES
    assert tuple(global_batch_sharding(mesh, TRAIN_RULES).spec) \
        == tuple(jpipe.global_batch_sharding(jmesh, JRULES).spec) \
        == (("pod", "data"), None)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [(3e-4, 10, 200), (1e-3, 1, 24),
                                  (0.1, 5, 1000), (3e-4, 0, 50)])
def test_schedules_equal_the_reference(spec):
    base_lr, warm, total = spec
    steps = np.arange(total + 5)
    want = np.asarray(jsched.warmup_cosine(jnp.asarray(steps), base_lr, warm,
                                           total))
    got = warmup_cosine(torch.as_tensor(steps), base_lr, warm, total)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for s in (0, warm, total // 2, total + 3):    # scalar steps
        assert float(warmup_cosine(s, base_lr, warm, total)) \
            == float(jsched.warmup_cosine(s, base_lr, warm, total))
    np.testing.assert_array_equal(
        constant(torch.as_tensor(steps), base_lr).numpy(),
        np.asarray(jsched.constant(jnp.asarray(steps), base_lr)))


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def test_quantize_round_trip_matches_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    cases = [
        (rng.normal(size=(37, 5)).astype(np.float32),
         np.zeros((37, 5), np.float32)),
        (rng.normal(size=(4, 3, 8)).astype(np.float32) * 1e-3,
         rng.normal(size=(4, 3, 8)).astype(np.float32) * 1e-5),
        # ties: xf / scale lands on .5, which rounds half to even
        (np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32),
         np.zeros(7, np.float32)),
        (np.zeros((3, 3), np.float32), np.zeros((3, 3), np.float32)),
        (rng.normal(size=(16,)).astype(jnp.bfloat16),
         np.zeros(16, np.float32)),
    ]
    for x, e in cases:
        jq, js, je = jcomp.quantize_int8(jnp.asarray(x), jnp.asarray(e))
        xt = torch.from_numpy(np.asarray(x, np.float32))
        if x.dtype != np.float32:
            xt = xt.to(torch.bfloat16)
        q, s, ne = quantize_int8(xt, torch.from_numpy(e))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(ne.numpy(), np.asarray(je))
        np.testing.assert_array_equal(
            dequantize(q, s).numpy(),
            np.asarray(jcomp.dequantize(jq, js)))
    np.testing.assert_array_equal(
        quantize_int8(torch.tensor([127.0, 0.5, 1.5, 2.5]),
                      torch.zeros(4))[0].numpy(), [127, 0, 2, 2])


def test_error_feedback_state_and_mesh_reductions():
    grads = {"a": torch.ones((2, 3), dtype=torch.bfloat16),
             "b": [torch.ones(4)]}
    err = init_error_feedback(grads)
    assert err["a"].dtype == torch.float32 and err["a"].shape == (2, 3)
    assert float(err["b"][0].abs().sum()) == 0.0
    # the mean over a mesh axis runs on torch.distributed
    # (tests/test_torch_mesh.py); an axis no active mesh binds raises
    for fn, arg, e in ((compressed_pmean, grads, err),
                       (compressed_pmean_leaf, grads["a"], err["a"])):
        with pytest.raises(NameError, match="unbound axis name: pod"):
            fn(arg, e, "pod")


# ---------------------------------------------------------------------------
# analytic parameter counts and FLOPs
# ---------------------------------------------------------------------------

def test_param_counts_and_model_flops_equal_the_reference():
    archs = jbase.list_archs()
    assert len(archs) >= 10
    shapes = list(jbase.SHAPES.values()) + [jinputs.SMOKE_SHAPE,
                                            jinputs.SMOKE_PREFILL,
                                            jinputs.SMOKE_DECODE]
    for arch in archs:
        for reduce in (False, True):
            jcfg = jbase.get_config(arch)
            cfg = base.get_config(arch)
            if reduce:
                jcfg, cfg = jinputs.reduced_config(jcfg), \
                    inputs.reduced_config(cfg)
            assert roofline.param_counts(cfg) == jroof.param_counts(jcfg)
            for shp in shapes:
                port_shape = base.ShapeSpec(shp.name, shp.seq_len,
                                            shp.global_batch, shp.kind)
                assert roofline.model_flops(cfg, port_shape) \
                    == jroof.model_flops(jcfg, shp), (arch, shp.name)
    # a dry-run record's row: its per-rank counts over the H100's rates
    rec = {"arch": "qwen1.5-0.5b", "shape": "train_4k", "mesh": "pod16x16",
           "mesh_shape": {"data": 16, "model": 16}, "fits": True,
           "memory": {"peak_bytes": 2 ** 31},
           "hlo": {"flops": 2e13, "bytes_accessed": 1e10,
                   "total_collective_wire": 9e9}}
    cfg, shape = base.get_config("qwen1.5-0.5b"), base.SHAPES["train_4k"]
    row = roofline.roofline_from_record(rec, cfg, shape)
    assert row.compute_s == 2e13 / roofline.H100_SXM_BF16_FLOPS
    assert row.memory_s == 1e10 / roofline.H100_SXM_HBM_BYTES_PER_S
    assert row.collective_s == 9e9 / roofline.H100_SXM_NVLINK_BYTES_PER_S
    assert row.bound == "compute" and row.peak_gib == 2.0
    assert row.hlo_flops_global == 2e13 * 256
    assert row.model_flops == roofline.model_flops(cfg, shape)
