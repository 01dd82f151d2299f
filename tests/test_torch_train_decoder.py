"""The port's decoder training entry point (``train_decoder.train``) and the
data path it reads, against the JAX package, on the CPU at a tiny size.

Synthetic data, the npz loaders, the registry and ``make_seq_batch`` are
numpy on both sides: they must be array-equal. The generative eval runs
the constrained beam search over exhaustive candidates (no noise to
match), on parameters converted from the JAX ones: its hit rates must
equal JAX's. ``train`` itself runs end to end on the CPU over a tiny port
stage-1 checkpoint, through the short attention route (Dh = 64, the switch
on): losses finite and falling, eval loss and hit rates logged, a
checkpoint written, and a second call resuming and extending the run.
"""
import dataclasses
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data import dataset as jds
from rqvae_tpu.data import registry as jreg
from rqvae_tpu.data import synthetic as jsyn
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.parallel import mesh as jmesh
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu.train import train_decoder as jtd
from rqvae_tpu.utils import config as jconfig
from rqvae_tpu_torch.data import dataset as tds
from rqvae_tpu_torch.data import registry as treg
from rqvae_tpu_torch.data import synthetic as tsyn
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import retrieval as tret
from rqvae_tpu_torch.tokenizer import semids as tsem
from rqvae_tpu_torch.train import checkpoint as tckpt
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.train import train_rqvae as ttr
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.logging import MetricsLogger
from rqvae_tpu_torch.utils.tree import tree_leaves

REPO = pathlib.Path(__file__).resolve().parent.parent


def _assert_seqs_equal(a, b):
    for name in ("user_ids", "item_ids", "item_ids_fut"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a.max_seq_len == b.max_seq_len


def test_synthetic_sequences_equal_jax():
    for kw in ({"n_users": 50, "seed": 3}, {"n_users": 7, "max_seq_len": 9, "seed": 0,
                                            "n_clusters": 5}):
        want, got = jsyn.synthetic_sequences(300, **kw), tsyn.synthetic_sequences(300, **kw)
        for a, b in zip(got, want):
            _assert_seqs_equal(a, b)


def test_registry_synthetic_equals_jax():
    kw = {"n_items": 200, "feature_dim": 12, "n_users": 40, "seed": 5}
    want = jreg.load("SYNTHETIC", "unused", synthetic_kwargs=dict(kw))
    got = treg.load(treg.RecDataset.SYNTHETIC, "unused", synthetic_kwargs=dict(kw))
    np.testing.assert_array_equal(got.items.x, want.items.x)
    np.testing.assert_array_equal(got.items.is_train, want.items.is_train)
    for name in ("train_seqs", "eval_seqs", "test_seqs"):
        _assert_seqs_equal(getattr(got, name), getattr(want, name))
    assert got.max_seq_len == want.max_seq_len == 20
    items_only = treg.load("SYNTHETIC", "unused", need_seqs=False, synthetic_kwargs=dict(kw))
    assert items_only.train_seqs is None
    np.testing.assert_array_equal(items_only.items.x, want.items.x)


def test_npz_loaders_and_registry_artifacts_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    d = tmp_path / "processed_beauty"
    d.mkdir()
    np.savez(d / "items.npz", x=rng.randn(30, 6).astype(np.float64), is_train=rng.rand(30) > 0.2)
    for sp, n in (("train", 9), ("eval", 4)):   # no test split on disk: None
        np.savez(d / f"seqs_{sp}.npz", user_ids=np.arange(n), item_ids=rng.randint(-1, 30, (n, 25)),
                 item_ids_fut=rng.randint(0, 30, (n, 1)))
    a, b = tds.load_item_dataset(str(d / "items.npz")), jds.load_item_dataset(str(d / "items.npz"))
    assert a.x.dtype == np.float32 and a.is_train.dtype == bool
    np.testing.assert_array_equal(a.x, b.x)
    _assert_seqs_equal(tds.load_seq_dataset(str(d / "seqs_eval.npz"), 20),
                       jds.load_seq_dataset(str(d / "seqs_eval.npz"), 20))
    got = treg.load("AMAZON", str(tmp_path), split="beauty")
    want = jreg.load("AMAZON", str(tmp_path), split="beauty")
    np.testing.assert_array_equal(got.items.x, want.items.x)
    _assert_seqs_equal(got.train_seqs, want.train_seqs)
    _assert_seqs_equal(got.eval_seqs, want.eval_seqs)
    assert got.test_seqs is None and want.test_seqs is None
    assert treg.load("AMAZON", str(tmp_path), split="beauty", need_seqs=False).train_seqs is None
    for load in (treg.load, jreg.load):
        with pytest.raises(FileNotFoundError, match="processed"):
            load("ML_1M", str(tmp_path))


@pytest.mark.parametrize("with_features", [True, False])
@pytest.mark.parametrize("subsample", [True, False])
def test_make_seq_batch_equals_jax(with_features, subsample):
    train, _ = tsyn.synthetic_sequences(50, n_users=30, seed=2)
    items = tsyn.synthetic_items(50, 8, seed=1)
    raw = train.batch_at(np.arange(3, 19), np.random.default_rng(0) if subsample else None)
    got = tds.make_seq_batch(raw, items.x, with_features=with_features)
    want = jds.make_seq_batch(raw, items.x, with_features=with_features)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    on_dev = tds.to_device(got, "cpu")
    assert all(isinstance(t, torch.Tensor) for t in on_dev)
    assert on_dev.seq_mask.dtype == torch.bool and tuple(on_dev.ids.shape) == (16, 20)


K = 16
N_ITEMS = 60
JCFG = jret.RetrievalConfig(
    embedding_dim=16, attn_dim=32, dropout=0.0, num_heads=2, n_layers=2, num_embeddings=K,
    sem_id_dim=4, max_pos=20 * 4, input_dropout=0.0, mlp_hidden_dim=32,
)


def test_run_generative_eval_equals_jax_hit_rates():
    """Exhaustive candidates (generation_candidates >= K), so no noise: the
    hit rates over 13 eval rows in batches of 8 (the last padded, its
    padding masked out) equal JAX's."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, K, (N_ITEMS, 3)).astype(np.int32)
    dedup = np.asarray(jax.jit(jsem.dedup_column, static_argnums=1)(jnp.asarray(ids), K))
    cached = np.concatenate([ids, dedup[:, None]], axis=1).astype(np.int32)
    jindex = jsem.build_index(jnp.asarray(cached), codebook_size=K)
    tindex = tsem.build_index(torch.from_numpy(cached), K)
    jp = jax.device_get(jax.jit(lambda key: jret.init(key, JCFG))(jax.random.PRNGKey(1)))
    tp = convert.from_numpy(jp, device="cpu")
    _, seqs = tsyn.synthetic_sequences(N_ITEMS, n_users=130, seed=4)
    items = tsyn.synthetic_items(N_ITEMS, 8, seed=1)
    kw = dict(batch_size=8, generation_top_k=10, generation_candidates=K)
    jcfg = jtd.DecoderTrainConfig(**kw)
    tcfg = ttd.DecoderTrainConfig(**kw)
    assert len(seqs) == 13
    mesh = jmesh.make_mesh((1, 1), devices=jax.devices()[:1])
    want = jtd.run_generative_eval(jax.tree.map(jnp.asarray, jp), JCFG, jindex, seqs, items, jcfg,
                                   mesh, jax.random.key(0), n_eval=13)
    tmodel = tret.RetrievalConfig(**{f: getattr(JCFG, f) for f in JCFG.__dataclass_fields__})
    got = ttd.run_generative_eval(tp, tmodel, tindex, seqs, items, tcfg, None, n_eval=13)
    assert set(got) == set(want) and "ndcg@10" in got
    for key in want:
        assert got[key] == pytest.approx(float(want[key]), abs=1e-6), key
    assert any(v > 0 for v in got.values())


class CaptureLogger(MetricsLogger):
    def __init__(self):
        super().__init__(every=1)
        self.records = []

    def log(self, step, metrics, force=False):
        self.records.append({"step": step, **{k: float(v) for k, v in metrics.items()}})


VAE = dict(dataset="SYNTHETIC", vae_input_dim=16, vae_hidden_dims=(16,), vae_embed_dim=8,
           vae_codebook_size=16, vae_n_cat_feats=0, vae_n_layers=3,
           vae_codebook_mode="ROTATION_TRICK", synthetic_n_items=300, seed=0)


@pytest.fixture(scope="module")
def stage1_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage1")
    cfg = tconfig.from_dict(ttr.RqVaeTrainConfig, dict(
        VAE, iterations=16, batch_size=32, eval_every=10**9, save_model_every=10**9,
        save_dir_root=str(root / "rq"), log_every=100, kmeans_prime_items=200, steps_per_call=4))
    params = ttr.train(cfg, logger=CaptureLogger(), device="cpu")
    return str(root / "rq"), params


def _decoder_cfg(tmp_path, rq_path, **kw):
    fields = dict(
        VAE, iterations=20, batch_size=8, learning_rate=1e-3, pretrained_rqvae_path=rq_path,
        save_dir_root=str(tmp_path / "dec"), synthetic_n_users=200, attn_embed_dim=128,
        attn_heads=2, attn_layers=4, decoder_embed_dim=16, dropout_p=0.1, log_every=10,
        partial_eval_every=10, full_eval_every=20, eval_batches=2, warmup_steps=10,
        generation_top_k=8, generation_candidates=16, amp=False)
    return tconfig.from_dict(ttd.DecoderTrainConfig, {**fields, **kw})


def test_load_frozen_rqvae_restores_the_stage1_checkpoint(stage1_ckpt, tmp_path):
    rq_path, trained = stage1_ckpt
    params, vae_cfg = ttd.load_frozen_rqvae(_decoder_cfg(tmp_path, rq_path), device="cpu")
    assert vae_cfg.codebook_kmeans_init is False and vae_cfg.n_layers == 3
    for a, b in zip(tree_leaves(params), tree_leaves(trained)):
        assert not a.requires_grad
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy())
    with pytest.raises(ValueError, match="does not fit"):
        ttd.load_frozen_rqvae(_decoder_cfg(tmp_path, rq_path, vae_embed_dim=4), device="cpu")


def test_train_runs_evals_saves_and_resumes_on_the_short_route(stage1_ckpt, tmp_path, monkeypatch):
    monkeypatch.setenv("RQVAE_TPU_SHORT_FLASH", "1")
    from rqvae_tpu_torch.ops import attention as tattn

    calls = []
    real = tattn.flash_attention_small_plain
    monkeypatch.setattr(tattn, "flash_attention_small_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rq_path, _ = stage1_ckpt
    cfg = _decoder_cfg(tmp_path, rq_path)
    log1 = CaptureLogger()
    ttd.train(cfg, logger=log1, device="cpu")
    assert calls   # every attention call of the step is short (81 / 5 tokens, Dh = 64)
    train_logs = [r for r in log1.records if "total_loss" in r]
    assert [r["step"] for r in train_logs] == [1, 10, 20]
    losses = [r["total_loss"] for r in train_logs]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert all(f"loss_{d}" in train_logs[0] and "train_seq_length_p0.5" in train_logs[0]
               for d in range(4))
    evals = [r for r in log1.records if "eval_loss" in r]
    assert [r["step"] for r in evals] == [10, 20] and all(math.isfinite(r["eval_loss"]) for r in evals)
    assert "eval_seq_length_p0.9" in evals[0]
    gen = [r for r in log1.records if "ndcg@10" in r]
    assert [r["step"] for r in gen] == [20]
    assert all(0.0 <= v <= 1.0 for k, v in gen[0].items() if k.startswith(("h@", "ndcg")))
    assert tckpt.latest_step(cfg.save_dir_root) == 19
    state, meta = tckpt.restore(cfg.save_dir_root, device="cpu")
    assert meta["step"] == 19 and state["opt_state"].count == 20
    assert meta["config"]["attn_embed_dim"] == 128

    # the same directory again: resumes at step 21 and trains 20 more
    log2 = CaptureLogger()
    ttd.train(cfg, logger=log2, device="cpu")
    steps = [r["step"] for r in log2.records if "total_loss" in r]
    assert steps[0] == 21 and steps[-1] == 40
    assert tckpt.latest_step(cfg.save_dir_root) == 39
    assert tckpt.restore(cfg.save_dir_root, device="cpu")[0]["opt_state"].count == 40


UNPORTED = {"mesh_shape": (1, 2), "tensor_parallel": True}   # tensor parallelism


@pytest.mark.parametrize("field", sorted(UNPORTED))
def test_train_refuses_unported_options(field, stage1_ckpt, tmp_path):
    """Tensor parallelism is ported: ``tensor_parallel=True`` in a world of
    one runs (a model axis of 1: one process, the losses of the default
    run); ``mesh_shape=(1, 2)`` does not cover a world of one and raises
    ``ValueError``. Two- and four-rank runs: test_torch_tensor_parallel.py."""
    rq_path, _ = stage1_ckpt
    cfg = dataclasses.replace(_decoder_cfg(tmp_path, rq_path, iterations=2, log_every=1,
                                           partial_eval_every=0, full_eval_every=0),
                              **{field: UNPORTED[field]})
    if field == "mesh_shape":
        with pytest.raises(ValueError, match=r"\(1, 2\) does not cover the 1 processes"):
            ttd.train(cfg, device="cpu")
        return
    logs = [CaptureLogger(), CaptureLogger()]
    ttd.train(cfg, logger=logs[0], device="cpu")
    ttd.train(dataclasses.replace(cfg, tensor_parallel=False,
                                  save_dir_root=str(tmp_path / "plain")), logger=logs[1],
              device="cpu")
    losses = [[r["total_loss"] for r in log.records if "total_loss" in r] for log in logs]
    assert len(losses[0]) == 2 and losses[0] == losses[1]


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("decoder_*.json")),
                         ids=lambda p: p.name)
def test_every_decoder_config_loads_as_jax_loads_it(path):
    want = jconfig.load_config(jtd.DecoderTrainConfig, str(path), [])
    got = tconfig.load_config(ttd.DecoderTrainConfig, str(path), [])
    names = [f.name for f in dataclasses.fields(ttd.DecoderTrainConfig)]
    assert names == [f.name for f in dataclasses.fields(jtd.DecoderTrainConfig)]
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        a, b = (a.name, b.name) if hasattr(a, "name") else (a, b)
        assert a == b, name
    assert dataclasses.asdict(got.vae_config()).keys() == dataclasses.asdict(want.vae_config()).keys()


def test_main_parses_a_config_and_overrides(monkeypatch):
    seen = {}
    monkeypatch.setattr(ttd, "train", lambda cfg: seen.setdefault("cfg", cfg))
    ttd.main([str(REPO / "configs" / "decoder_amazon.json"), "dataset=SYNTHETIC",
              "synthetic_n_items=12101", "iterations=5"])
    cfg = seen["cfg"]
    assert cfg.iterations == 5 and cfg.dataset.name == "SYNTHETIC" and cfg.attn_embed_dim == 512
    assert cfg.retrieval_config(20).max_pos == 80 and cfg.synthetic_n_items == 12101
