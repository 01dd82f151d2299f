"""The port's decoder training path against the JAX package, on the CPU at a
small size that still reaches the flash route: 64-item histories give 257
encoder tokens, and attn_dim 128 over 2 heads gives Dh = 64.

Parameters come from the JAX ``retrieval.init`` and cross as numpy;
batches are numpy-seeded; everything runs in fp32 with dropout 0 (dropout
noise cannot be bit-matched across frameworks; its distribution is tested
on its own). To compare gradients, both packages' step functions run with
an optimizer whose state becomes the gradient it was given.

Tolerances: losses and logits 1e-5; gradients 1e-4 of each leaf's max-abs
(fp32 sums taken in other orders over two layers); AdamW 1e-6 on identical
gradients.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rqvae_tpu.data.schemas import SeqBatch as JSeqBatch
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu.train import optim as joptim
from rqvae_tpu.train import train_decoder as jtd
from rqvae_tpu.utils import config as jconfig
from rqvae_tpu_torch.data.schemas import SeqBatch as TSeqBatch
from rqvae_tpu_torch.models import convert, dropout, embeddings, mlp, normalize, quantize
from rqvae_tpu_torch.models import retrieval as tret
from rqvae_tpu_torch.models import transformer
from rqvae_tpu_torch.tokenizer import semids as tsem
from rqvae_tpu_torch.train import optim as toptim
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path, tree_map

REPO = pathlib.Path(__file__).resolve().parent.parent
K = 16
N_HIST = 64
N_ITEMS = 60
JCFG = jret.RetrievalConfig(
    embedding_dim=16, attn_dim=128, dropout=0.0, num_heads=2, n_layers=2, num_embeddings=K,
    sem_id_dim=4, max_pos=N_HIST * 4, input_dropout=0.0, mlp_hidden_dim=64,
)
TCFG = tret.RetrievalConfig(**{f: getattr(JCFG, f) for f in JCFG.__dataclass_fields__})


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, K, (N_ITEMS, 3)).astype(np.int32)
    dedup = np.asarray(jax.jit(jsem.dedup_column, static_argnums=1)(jnp.asarray(ids), K))
    cached = np.concatenate([ids, dedup[:, None]], axis=1).astype(np.int32)
    jindex = jsem.build_index(jnp.asarray(cached), codebook_size=K)
    tindex = tsem.build_index(torch.from_numpy(cached), K)
    jp = jax.device_get(jax.jit(lambda key: jret.init(key, JCFG))(jax.random.PRNGKey(0)))
    return jindex, tindex, jax.tree.map(jnp.asarray, jp), convert.from_numpy(jp, device="cpu")


def _raw(seed, lengths):
    rng = np.random.RandomState(seed)
    b = len(lengths)
    ids = rng.randint(0, N_ITEMS, (b, N_HIST)).astype(np.int32)
    ids = np.where(np.arange(N_HIST)[None] < np.asarray(lengths)[:, None], ids, -1)
    return {"user_ids": np.arange(b, dtype=np.int32) * 37 + seed, "ids": ids,
            "ids_fut": rng.randint(0, N_ITEMS, (b, 1)).astype(np.int32)}


def _batches(raw, lead=None):
    """The same SeqBatch for both packages; ``lead`` stacks raws on a
    leading accum axis."""
    raws = [raw] if lead is None else lead
    arrays = {k: np.stack([r[k] for r in raws]) if lead is not None else raw[k] for k in raw}
    arrays["seq_mask"] = arrays["ids"] >= 0
    arrays["x"] = np.zeros(arrays["ids"].shape + (1,), np.float32)
    arrays["x_fut"] = np.zeros(arrays["ids_fut"].shape + (1,), np.float32)
    return (JSeqBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TSeqBatch(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}))


RAW = _raw(1, [64, 64, 30, 10])   # 257 encoder tokens; buckets of 64 and 32 items


def _leaves(tree):
    return [(p, np.asarray(x.detach() if isinstance(x, torch.Tensor) else x))
            for p, x in tree_leaves_with_path(tree)]


def _assert_grads_close(got, want, rel=1e-4):
    got, want = _leaves(got), _leaves(jax.device_get(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        scale = max(float(np.abs(b).max()), 1e-12)
        assert np.abs(a - b).max() <= rel * scale, (path, float(np.abs(a - b).max()), scale)


class _CaptureGrads:
    """A port optimizer that leaves the params alone and keeps the grads."""

    def update(self, params, state, grads):
        return grads


JCAPTURE = optax.GradientTransformation(
    lambda p: None, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_forward_at_flash_length_matches_jax(setup):
    jindex, tindex, jp, tp = setup
    jb, tb = _batches(RAW)
    jtok = jsem.tokenize_sequences(jindex, jb)
    assert jtok.sem_ids.shape[1] + 1 == 257
    want = jax.jit(lambda p, t: jret.forward(p, JCFG, t))(jp, jtok)
    gen = torch.Generator().manual_seed(0)
    got = tret.forward(tp, TCFG, tsem.tokenize_sequences(tindex, tb), training=True, generator=gen)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(want.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.loss_d.detach().numpy(), np.asarray(want.loss_d),
                               rtol=1e-5, atol=1e-5)


def test_microbatch_loss_gradients_match_jax(setup):
    jindex, tindex, jp, tp = setup
    jb, tb = _batches(RAW)
    jloss = jtd._make_microbatch_loss(JCFG, jindex, jnp.float32)
    jvalue, want = jax.jit(jax.value_and_grad(lambda p, b: jloss(p, b, None)[0]))(jp, jb)
    tloss = ttd._make_microbatch_loss(TCFG, tindex, torch.float32)
    loss, _, got = ttd.value_and_grad(tloss, tp, tb, None)
    np.testing.assert_allclose(float(loss), float(jvalue), rtol=1e-5, atol=1e-5)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_jax(setup, accum):
    jindex, tindex, jp, tp = setup
    raws = [RAW, _raw(2, [64, 40, 20, 3])][:accum]
    jb, tb = _batches(RAW, lead=raws)
    jstep = jax.jit(jtd.make_train_step(JCFG, JCAPTURE, jindex, accum, jnp.float32, 4))
    _, jgrads, jm = jstep(jp, None, jb, jax.random.key(0))
    tstep = ttd.make_train_step(TCFG, _CaptureGrads(), tindex, accum, torch.float32, 4)
    _, tgrads, tm = tstep(tp, None, tb, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm["loss_d"].numpy(), np.asarray(jm["loss_d"]), rtol=1e-5, atol=1e-5)
    _assert_grads_close(tgrads, jgrads)


def test_bucket_slices_match_jax():
    lengths = np.random.RandomState(3).randint(0, 200, 64)
    for n in (1, 2, 4):
        want, got = jtd.bucket_slices(lengths, n), ttd.bucket_slices(lengths, n)
        assert len(want) == len(got) == n
        for (wr, wl), (gr, gl) in zip(want, got):
            np.testing.assert_array_equal(gr, wr)
            assert gl == wl


def test_bucketed_fns_match_jax_and_the_flat_step(setup):
    jindex, tindex, jp, tp = setup
    jacc, japply = jtd.make_bucketed_fns(JCFG, JCAPTURE, jindex, jnp.float32, 4)
    tacc, tapply = ttd.make_bucketed_fns(TCFG, _CaptureGrads(), tindex, torch.float32, 4)
    jg = jax.tree.map(jnp.zeros_like, jp)
    jl, jld = jnp.float32(0.0), jnp.zeros((4,), jnp.float32)
    tg = tree_map(torch.zeros_like, tp)
    tl, tld = torch.zeros(()), torch.zeros(4)
    groups = ttd.bucket_slices((RAW["ids"] >= 0).sum(axis=1), 2)
    assert [length for _, length in groups] == [64, 32]   # one flash group, one dense
    for rows, length in groups:
        sub = {"user_ids": RAW["user_ids"][rows], "ids": RAW["ids"][rows, :length],
               "ids_fut": RAW["ids_fut"][rows]}
        jb, tb = _batches(sub)
        jg, jl, jld = jacc(jp, jg, jl, jld, jb, None, jnp.float32(0.5))
        tg, tl, tld = tacc(tp, tg, tl, tld, tb, None, 0.5)
    _, jgrads = japply(jp, None, jg)
    _, tgrads = tapply(tp, None, tg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    _assert_grads_close(tgrads, jgrads)
    # the port's bucketed gradients equal its flat gradients
    _, flat_grads, flat_m = ttd.make_train_step(TCFG, _CaptureGrads(), tindex, 1, torch.float32, 4)(
        tp, None, _batches(RAW, lead=[RAW])[1], None)
    np.testing.assert_allclose(float(tl), float(flat_m["total_loss"]), rtol=1e-5, atol=1e-5)
    for (path, a), (_, b) in zip(_leaves(tgrads), _leaves(flat_grads)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6, err_msg=str(path))


def test_adamw_and_schedule_match_optax_on_identical_gradients():
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(5, 3).astype(np.float32), "layers": [rng.randn(7).astype(np.float32),
                                                                    rng.randn(2, 2).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32) * 10.0 ** rng.randint(-6, 1),
                          params) for _ in range(5)]
    jopt = joptim.adamw(joptim.inv_sqrt_schedule(1e-2, 2), 0.035)
    topt = toptim.adamw(toptim.inv_sqrt_schedule(1e-2, 2), 0.035)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = convert.from_numpy(params, device="cpu")
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        assert topt.lr(step) == pytest.approx(float(joptim.inv_sqrt_schedule(1e-2, 2)(step)), rel=1e-6)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(tp, ts, convert.from_numpy(g, device="cpu"))
        for (path, a), (_, b) in zip(_leaves(tp), _leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f"step {step} {path}")
    assert ts.count == 5


def test_dropout_zero_is_identity_and_p_keeps_share_and_scale():
    x = torch.randn(100_000)
    gen = torch.Generator().manual_seed(0)
    assert dropout.dropout(x, 0.0, True, gen) is x
    assert dropout.dropout(x, 0.3, False, gen) is x
    y = dropout.dropout(x, 0.3, True, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), (x[kept] / 0.7).numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        dropout.dropout(x, 0.3, True, None)


def test_training_with_zero_dropout_equals_eval(setup):
    _, tindex, _, tp = setup
    cfg = dataclasses.replace(TCFG, dropout=0.0, input_dropout=0.0)
    tok = tsem.tokenize_sequences(tindex, _batches(RAW)[1])
    a = tret.forward(tp, cfg, tok, training=True, generator=torch.Generator().manual_seed(1))
    b = tret.forward(tp, cfg, tok)
    assert torch.equal(a.logits, b.logits)
    # with dropout on, two generators draw two different losses
    cfg = dataclasses.replace(TCFG, dropout=0.3, input_dropout=0.5)
    l1 = tret.forward(tp, cfg, tok, training=True, generator=torch.Generator().manual_seed(1)).loss
    l2 = tret.forward(tp, cfg, tok, training=True, generator=torch.Generator().manual_seed(2)).loss
    assert torch.isfinite(l1) and float(l1) != float(l2)


def test_load_config_matches_jax_on_the_ml32m_decoder_config():
    path = str(REPO / "configs" / "decoder_ml32m.json")
    want = jconfig.load_config(jtd.DecoderTrainConfig, path, ["batch_size=256"])
    got = tconfig.load_config(ttd.DecoderTrainConfig, path, ["batch_size=256"])
    fields = [f.name for f in dataclasses.fields(ttd.DecoderTrainConfig)]
    assert set(fields) <= {f.name for f in dataclasses.fields(jtd.DecoderTrainConfig)}
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        a, b = (a.name, b.name) if hasattr(a, "name") else (a, b)
        assert a == b, name
    assert got.length_buckets == 2 and got.batch_size == 256
    assert dataclasses.asdict(got.retrieval_config(200)) == dataclasses.asdict(want.retrieval_config(200))


INITS = {
    "transformer.init": lambda **kw: transformer.init(
        torch.Generator(), transformer.TransformerConfig(d_model=8, num_heads=2, encoder_layers=1,
                                                         decoder_layers=1, mlp_hidden_dim=8), **kw),
    "mlp.init": lambda **kw: mlp.init(torch.Generator(), 4, (8,), 4, **kw),
    "embeddings.sem_id_embedder_init": lambda **kw: embeddings.sem_id_embedder_init(
        torch.Generator(), 8, 4, 4, **kw),
    "embeddings.user_id_embedder_init": lambda **kw: embeddings.user_id_embedder_init(
        torch.Generator(), 8, 4, **kw),
    "quantize.init": lambda **kw: quantize.init(torch.Generator(), 8, 4, True, **kw),
    "normalize.rms_norm_init": lambda **kw: normalize.rms_norm_init(4, **kw),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_defaults_need_cuda_unless_cpu_requested(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        INITS[name]()
    out = INITS[name](device="cpu")
    leaves = [x for _, x in tree_leaves_with_path(out)]
    assert leaves and all(x.device.type == "cpu" for x in leaves)
