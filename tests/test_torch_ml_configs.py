"""The shipped MovieLens configs' paths through the port's entry points on the
CPU, held against the JAX package's loops on the same fixtures.

Raw fixtures of the ML-32M and ML-1M shapes (``chip_smoke``'s writers, cut
to a few hundred movies and tens of users) go through both packages'
``movielens.process`` with the hashed stub encoder: the artifacts must be
array-equal. Then both packages' ``train()`` loops run from the same
JAX-initialised parameters and Adam state, written as a checkpoint of each
package's format at step 0 (``pretrained_*_path``), on the same artifacts:

* ``train_rqvae.train`` with ``configs/rqvae_ml32m.json``'s rotation-trick
  estimator (embed 64) and ``configs/rqvae_ml1m.json``'s Gumbel-softmax
  (embed 32), widths and codebooks cut, the host-fed loop; the Gumbel
  uniforms are injected on both sides (one seeded draw a shape), since the
  two packages' generators draw other streams;
* ``train_decoder.train`` with ``configs/decoder_ml32m.json``'s
  ``length_buckets: 2``, then with ``packed_rows > 0``, then with
  ``gradient_accumulate_every: 2``, widths cut (6 heads kept), at dropout 0:
  the config's ``dropout_p`` set to 0 and the model's input dropout patched
  to 0 in both packages.

The logged losses (train and eval) must agree to ``rtol=1e-4`` at every
logged step: the same data draws (one numpy stream each) and the same
updates, fp32 sums taken in another order. The constrained-beam-search eval
is stubbed on both sides (its parity is ``tests/test_torch_run_eval.py``'s
and ``tests/test_torch_train_decoder.py``'s).
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data import movielens as jml
from rqvae_tpu.models import quantize as jquant
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu.train import checkpoint as jckpt
from rqvae_tpu.train import optim as joptim
from rqvae_tpu.train import train_decoder as jtd
from rqvae_tpu.train import train_rqvae as jtr
from rqvae_tpu.utils import config as jconfig
from rqvae_tpu.utils.logging import MetricsLogger as JLogger
from rqvae_tpu_torch.data import movielens as tml
from rqvae_tpu_torch.data.text import hashed_stub_encoder
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import quantize as tquant
from rqvae_tpu_torch.train import checkpoint as tckpt
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.train import train_rqvae as ttr
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.logging import MetricsLogger as TLogger

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CONFIGS = REPO / "configs"
FEAT = 16                     # the stub encoder's width here; the genre columns follow
RQ_CUT = ["vae_input_dim=16", "vae_hidden_dims=[32,16]", "vae_codebook_size=16",
          "iterations=4", "batch_size=16", "steps_per_call=1", "log_every=1", "eval_every=4",
          "save_model_every=100", "eval_batches=2", "seed=0"]
DEC_CUT = ["vae_input_dim=16", "vae_hidden_dims=[32,16]", "vae_codebook_size=16",
           "vae_codebook_mode=ROTATION_TRICK", "attn_embed_dim=48", "attn_layers=2",
           "decoder_embed_dim=16", "batch_size=8", "iterations=2", "log_every=1",
           "partial_eval_every=2", "full_eval_every=100", "save_model_every=100",
           "eval_batches=1", "dropout_p=0.0", "warmup_steps=10", "seed=0"]
# JAX shards every batch over its 8 CPU devices here: the rows a bucket or a
# packed batch holds are a multiple of 8
BRANCHES = {"buckets": ["batch_size=16"],
            "packed": ["length_buckets=1", "packed_rows=8", "pack_slots=4"],
            "accumulate": ["length_buckets=1", "gradient_accumulate_every=2"]}


class _Capture:
    def __init__(self):
        self.records = []

    def log(self, step, metrics, force=False):
        self.records.append({"step": step, **{k: float(np.asarray(v)) for k, v in metrics.items()
                                              if np.ndim(v) == 0}})


class JCapture(_Capture, JLogger):
    pass


class TCapture(_Capture, TLogger):
    pass


def _losses(records):
    return {(k, r["step"]): v for r in records for k, v in r.items() if "loss" in k}


def _assert_losses_equal(got, want, rtol=1e-4):
    a, b = _losses(got), _losses(want)
    assert set(a) == set(b) and len(a) >= 4, (sorted(a), sorted(b))
    for key in sorted(b):
        np.testing.assert_allclose(a[key], b[key], rtol=rtol, atol=1e-6, err_msg=str(key))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Both fixtures through both packages' preprocessors; the port's
    artifacts are the ones the loops read."""
    root = tmp_path_factory.mktemp("ml")
    encode = hashed_stub_encoder(dim=FEAT)
    out = {}
    for name, write in (("ml32m", lambda r: chip_smoke._write_ml32m_raw(r, 0, 300, 40, 40 * 45)),
                        ("ml1m", lambda r: chip_smoke._write_ml1m_raw(r, 1, 120, 40, 40 * 30))):
        for pkg, process in (("port", tml.process), ("jax", jml.process)):
            d = root / name / pkg
            write(str(d))
            process(str(d), name, encode_fn=encode)
        out[name] = str(root / name / "port")
    return root, out


def test_fixtures_process_to_jax_artifacts(data):
    root, _ = data
    for name in ("ml32m", "ml1m"):
        for art in ("items", "seqs_train", "seqs_eval"):
            got = np.load(root / name / "port" / "processed" / f"{art}.npz")
            want = np.load(root / name / "jax" / "processed" / f"{art}.npz")
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {art} {key}")
        items = np.load(root / name / "port" / "processed" / "items.npz")["x"]
        assert items.shape[1] == FEAT + (20 if name == "ml32m" else 18)


def _fixed_uniforms(monkeypatch):
    """One seeded U(0, 1) draw a shape, on both sides."""
    def draw(shape):
        return np.random.RandomState(int(np.prod(shape)) % 2**31).rand(*shape).astype(np.float32)

    real_t = tquant.gumbel_softmax_sample
    monkeypatch.setattr(tquant, "gumbel_softmax_sample", lambda logits, t, **kw: real_t(
        logits, t, uniform=torch.from_numpy(draw(tuple(logits.shape)))))

    def jsample(rng, logits, temperature):
        g = -jnp.log(-jnp.log(jnp.asarray(draw(logits.shape)) + 1e-20) + 1e-20)
        return jax.nn.softmax((logits + g) / temperature, axis=-1)

    monkeypatch.setattr(jquant, "gumbel_softmax_sample", jsample)


@pytest.mark.parametrize("config", ["rqvae_ml32m", "rqvae_ml1m"])
def test_train_rqvae_on_the_configs_equals_jax(data, tmp_path, monkeypatch, config):
    _, roots = data
    dataset = "ml32m" if config == "rqvae_ml32m" else "ml1m"
    fields = RQ_CUT + [f"data_path={roots[dataset]}"]
    jcfg = jconfig.load_config(jtr.RqVaeTrainConfig, str(CONFIGS / f"{config}.json"), fields + [
        f"pretrained_rqvae_path={tmp_path}/jinit", f"save_dir_root={tmp_path}/j"])
    tcfg = tconfig.load_config(ttr.RqVaeTrainConfig, str(CONFIGS / f"{config}.json"), fields + [
        f"pretrained_rqvae_path={tmp_path}/tinit", f"save_dir_root={tmp_path}/t"])
    assert (tcfg.vae_embed_dim, tcfg.vae_codebook_mode.name) == (
        (64, "ROTATION_TRICK") if dataset == "ml32m" else (32, "GUMBEL_SOFTMAX"))
    params = jax.device_get(jrq.init(jax.random.PRNGKey(3), jcfg.model_config()))
    opt_state = jax.device_get(joptim.adamw(jcfg.learning_rate, jcfg.weight_decay).init(params))
    jckpt.save(jcfg.pretrained_rqvae_path, 0, {"params": params, "opt_state": opt_state})
    tckpt.save(tcfg.pretrained_rqvae_path, 0, {
        "params": convert.from_numpy(params, device="cpu"),
        "opt_state": convert.adamw_state_from_numpy(opt_state, device="cpu")})
    _fixed_uniforms(monkeypatch)
    want, got = JCapture(), TCapture()
    jtr.train(jcfg, logger=want)
    ttr.train(tcfg, logger=got, device="cpu")
    _assert_losses_equal(got.records, want.records)
    assert any("eval_total_loss" in r for r in got.records)


def _no_input_dropout(monkeypatch):
    for mod in (jtd, ttd):
        real = mod.DecoderTrainConfig.retrieval_config
        monkeypatch.setattr(mod.DecoderTrainConfig, "retrieval_config",
                            lambda self, n, real=real: dataclasses.replace(real(self, n),
                                                                           input_dropout=0.0))
        monkeypatch.setattr(mod, "run_generative_eval", lambda *a, **kw: {})


@pytest.fixture(scope="module")
def stage1(data, tmp_path_factory):
    """A JAX-initialised ML-32M RQ-VAE (the cut config) in both formats."""
    root = tmp_path_factory.mktemp("rq")
    jcfg = jconfig.load_config(jtd.DecoderTrainConfig, str(CONFIGS / "decoder_ml32m.json"),
                               DEC_CUT)
    params = jax.device_get(jrq.init(jax.random.PRNGKey(4), jcfg.vae_config()))
    jckpt.save(str(root / "j"), 0, {"params": params})
    tckpt.save(str(root / "t"), 0, {"params": convert.from_numpy(params, device="cpu")})
    return root


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_train_decoder_branches_equal_jax(data, stage1, tmp_path, monkeypatch, branch):
    _, roots = data
    fields = DEC_CUT + BRANCHES[branch] + [f"data_path={roots['ml32m']}"]
    path = str(CONFIGS / "decoder_ml32m.json")
    jcfg = jconfig.load_config(jtd.DecoderTrainConfig, path, fields + [
        f"pretrained_rqvae_path={stage1}/j", f"pretrained_decoder_path={tmp_path}/jinit",
        f"save_dir_root={tmp_path}/j"])
    tcfg = tconfig.load_config(ttd.DecoderTrainConfig, path, fields + [
        f"pretrained_rqvae_path={stage1}/t", f"pretrained_decoder_path={tmp_path}/tinit",
        f"save_dir_root={tmp_path}/t"])
    assert tcfg.attn_heads == 6 and tcfg.length_buckets == (2 if branch == "buckets" else 1)
    _no_input_dropout(monkeypatch)
    model_cfg = jcfg.retrieval_config(200)
    assert model_cfg.input_dropout == model_cfg.dropout == 0.0
    params = jax.device_get(jret.init(jax.random.PRNGKey(5), model_cfg))
    opt = joptim.adamw(joptim.inv_sqrt_schedule(jcfg.learning_rate, jcfg.warmup_steps),
                       jcfg.weight_decay)
    opt_state = jax.device_get(opt.init(params))
    jckpt.save(jcfg.pretrained_decoder_path, 0, {"params": params, "opt_state": opt_state})
    tckpt.save(tcfg.pretrained_decoder_path, 0, {
        "params": convert.from_numpy(params, device="cpu"),
        "opt_state": convert.adamw_state_from_numpy(opt_state, device="cpu")})
    want, got = JCapture(), TCapture()
    jtd.train(jcfg, logger=want)
    ttd.train(tcfg, logger=got, device="cpu")
    _assert_losses_equal(got.records, want.records)
    assert [r["step"] for r in got.records if "total_loss" in r] == [2, 3]
    assert any("eval_loss" in r for r in got.records)
