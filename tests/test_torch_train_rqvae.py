"""The port's stage-1 training (``train/train_rqvae.py``) against the JAX
package on the CPU: the train step (accum 1 and 2, the plain and the fused
quantizer route), one real AdamW step from a converted optimizer state, the
device-resident chunk, the eval step, the corpus diversity metrics, the
temperature schedule, the configs, and ``train()`` with checkpoints and
auto-resume.

fp32 throughout on the JAX side's plain route. To compare gradients, both
step functions run with an optimizer whose state becomes the gradient it was
given. Tolerances: metrics 1e-5; gradients 1e-4 of each leaf's max-abs (fp32
sums in another order); AdamW parameters 1e-6; diversity metrics exact.
"""
import dataclasses
import glob
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rqvae_tpu.train import optim as joptim
from rqvae_tpu.train import temperature as jtemp
from rqvae_tpu.train import train_rqvae as jtr
from rqvae_tpu.utils import config as jconfig
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import rqvae as trq
from rqvae_tpu_torch.train import checkpoint as tckpt
from rqvae_tpu_torch.train import optim as toptim
from rqvae_tpu_torch.train import temperature as ttemp
from rqvae_tpu_torch.train import train_rqvae as ttr
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.logging import MetricsLogger
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path

from test_torch_rqvae_train import assert_leaves_close, inputs, leaves, model_cfgs, spread_params

REPO = pathlib.Path(__file__).resolve().parent.parent
METRICS = ("total_loss", "reconstruction_loss", "rqvae_loss", "p_unique_ids", "embs_norm_mean")


class _CaptureGrads:
    """A port optimizer that leaves the params alone and keeps the grads."""

    def update(self, params, state, grads):
        return grads


JCAPTURE = optax.GradientTransformation(
    lambda p: None, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def params():
    p = spread_params(seed=1)
    return jax.tree.map(jnp.asarray, p), p


def _tp(np_tree):
    return convert.from_numpy(np_tree, device="cpu")


@pytest.mark.parametrize("route", ["plain", "fused"])
@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_jax(params, accum, route, monkeypatch):
    jcfg, tcfg = model_cfgs()
    jp, np_tree = params
    x = np.stack([inputs(32, 20 + i) for i in range(accum)])
    jstep = jax.jit(jtr.make_train_step(jcfg, JCAPTURE, accum, jnp.float32))
    _, jgrads, jm = jstep(jp, None, jnp.asarray(x), jax.random.PRNGKey(0), jnp.float32(0.2))
    monkeypatch.setattr(trq, "FUSED_TRAIN_MIN_CODEBOOK_VOLUME",
                        0 if route == "fused" else float("inf"))
    tstep = ttr.make_train_step(tcfg, _CaptureGrads(), accum, torch.float32)
    tp = _tp(np_tree)
    _, tgrads, tm = tstep(tp, None, torch.from_numpy(x), torch.Generator().manual_seed(0), 0.2)
    for name in METRICS:
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert tm["embs_norm_mean"].shape == (3,)
    assert_leaves_close(tgrads, jgrads, 1e-4)


def test_one_adamw_step_from_a_converted_optimizer_state(params):
    jcfg, tcfg = model_cfgs()
    jp, _ = params
    jopt = joptim.adamw(1e-3, 0.01)
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt, 1, jnp.float32))
    t = jnp.float32(0.2)
    # one JAX step gives a state with nonzero moments and count 1
    jp, js, _ = jstep(jp, jopt.init(jp), jnp.asarray(inputs(32, 30)[None]), jax.random.PRNGKey(0), t)
    tp = _tp(jax.device_get(jp))
    ts = convert.adamw_state_from_numpy(jax.device_get(js), device="cpu")
    assert ts.count == 1
    x = inputs(32, 31)[None]
    jp, js, jm = jstep(jp, js, jnp.asarray(x), jax.random.PRNGKey(1), t)
    tp, ts, tm = ttr.make_train_step(tcfg, toptim.adamw(1e-3, 0.01), 1, torch.float32)(
        tp, ts, torch.from_numpy(x), None, 0.2)
    assert ts.count == 2
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5)
    for (path, a), (_, b) in zip(leaves(tp), leaves(jax.device_get(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=str(path))
    assert_leaves_close(ts.mu, js[0].mu, 1e-4)


def test_device_chunk_equals_successive_steps_on_the_same_draws(params):
    _, tcfg = model_cfgs()
    _, np_tree = params
    corpus = torch.from_numpy(inputs(200, 40))
    opt = toptim.adamw(1e-3, 0.01)
    n, bs = 3, 16
    pa, pb = _tp(np_tree), _tp(np_tree)
    sa, sb = opt.init(pa), opt.init(pb)
    chunk = ttr.make_device_chunk(tcfg, opt, 1, torch.float32, bs, n)
    pa, sa, ma = chunk(pa, sa, corpus, torch.Generator().manual_seed(5), 0.2)
    step = ttr.make_train_step(tcfg, opt, 1, torch.float32)
    gen = torch.Generator().manual_seed(5)
    ms = []
    for _ in range(n):
        idx = torch.randint(0, corpus.shape[0], (1, bs), generator=gen)
        pb, sb, m = step(pb, sb, corpus[idx], gen, 0.2)
        ms.append(m)
    assert sa.count == sb.count == n
    for (path, a), (_, b) in zip(leaves(pa), leaves(pb)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    for name in METRICS:
        mean = torch.stack([m[name] for m in ms]).mean(0)
        np.testing.assert_allclose(ma[name].numpy(), mean.numpy(), rtol=1e-6, err_msg=name)


def test_bf16_step_runs_both_routes_close_to_fp32(params, monkeypatch):
    _, tcfg = model_cfgs()
    _, np_tree = params
    x = torch.from_numpy(inputs(32, 41)[None])
    losses = {}
    for route in ("plain", "fused"):
        monkeypatch.setattr(trq, "FUSED_TRAIN_MIN_CODEBOOK_VOLUME",
                            0 if route == "fused" else float("inf"))
        for dt in (torch.float32, torch.bfloat16):
            _, grads, m = ttr.make_train_step(tcfg, _CaptureGrads(), 1, dt)(
                _tp(np_tree), None, x, None, 0.2)
            assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
                       for _, g in tree_leaves_with_path(grads))
            losses[route, dt] = float(m["total_loss"])
    for route in ("plain", "fused"):
        assert losses[route, torch.bfloat16] == pytest.approx(losses[route, torch.float32], rel=5e-2)


def test_eval_step_and_id_diversity_match_jax(params):
    jcfg, tcfg = model_cfgs()
    jp, np_tree = params
    tp = _tp(np_tree)
    x = inputs(32, 50)
    want = jtr.make_eval_step(jcfg, 0.2, jnp.float32)(jp, jnp.asarray(x))
    got = ttr.make_eval_step(tcfg, 0.2, torch.float32)(tp, torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    corpus = inputs(300, 51)
    want = jtr.id_diversity_metrics(jp, jcfg, jnp.asarray(corpus))
    got = ttr.id_diversity_metrics(tp, tcfg, torch.from_numpy(corpus))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    assert got["codebook_usage_0"] > 0.5


def test_temperature_schedule_matches_jax():
    kw = dict(t0=0.2, min_t=0.05, anneal_rate=3e-4, step_size=50)
    js, ts = jtemp.TemperatureScheduler(**kw), ttemp.TemperatureScheduler(**kw)
    for it in range(0, 3000, 7):
        assert ts.get_t(it) == js.get_t(it)
        assert ttemp.constant_t_chunk_bound(it, 50) == jtemp.constant_t_chunk_bound(it, 50)
    assert ttemp.ConstantTemperature(0.2).get_t(123) == 0.2


@pytest.mark.parametrize("path", sorted(glob.glob(str(REPO / "configs" / "rqvae_*.json"))),
                         ids=lambda p: pathlib.Path(p).name)
def test_rqvae_configs_load_to_the_jax_field_values(path):
    want = jconfig.load_config(jtr.RqVaeTrainConfig, path, ["iterations=7"])
    got = tconfig.load_config(ttr.RqVaeTrainConfig, path, ["iterations=7"])
    names = [f.name for f in dataclasses.fields(ttr.RqVaeTrainConfig)]
    assert names == [f.name for f in dataclasses.fields(jtr.RqVaeTrainConfig)]
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        a, b = (a.name, b.name) if hasattr(a, "name") else (a, b)
        assert a == b, name
    assert dataclasses.asdict(got.model_config()).keys() == dataclasses.asdict(want.model_config()).keys()
    assert got.model_config().codebook_mode.name == want.model_config().codebook_mode.name


class CaptureLogger(MetricsLogger):
    def __init__(self):
        super().__init__(every=1)
        self.records = []

    def log(self, step, metrics, force=False):
        self.records.append({"step": step, **metrics})


def _train_cfg(tmp_path, spc, **kw):
    fields = dict(
        iterations=12, batch_size=16, learning_rate=1e-3, dataset="SYNTHETIC",
        vae_input_dim=16, vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=16,
        vae_n_cat_feats=0, vae_n_layers=2, eval_every=10**9, save_model_every=12,
        save_dir_root=str(tmp_path / "ck"), log_every=4, synthetic_n_items=128,
        kmeans_prime_items=64, eval_batches=2, seed=0, steps_per_call=spc)
    return tconfig.from_dict(ttr.RqVaeTrainConfig, {**fields, **kw})


@pytest.mark.parametrize("spc", [1, 4])
def test_train_runs_evals_saves_and_resumes(tmp_path, spc):
    log1 = CaptureLogger()
    ttr.train(_train_cfg(tmp_path, spc), logger=log1, device="cpu")
    steps = [r["step"] for r in log1.records if "total_loss" in r]
    assert steps == [1, 4, 8, 12]
    assert all(math.isfinite(r["total_loss"]) for r in log1.records if "total_loss" in r)
    ev = [r for r in log1.records if "eval_total_loss" in r]
    assert [r["step"] for r in ev] == [12] and 0 < ev[0]["codebook_usage_0"] <= 1
    assert tckpt.latest_step(str(tmp_path / "ck")) == 11
    state, meta = tckpt.restore(str(tmp_path / "ck"), device="cpu")
    assert meta["step"] == 11 and meta["config"]["steps_per_call"] == spc
    assert state["opt_state"].count == 12

    # same directory, no pretrained path: resumes at step 13 and trains 12 more
    log2 = CaptureLogger()
    ttr.train(_train_cfg(tmp_path, spc), logger=log2, device="cpu")
    steps = [r["step"] for r in log2.records if "total_loss" in r]
    assert steps[0] == 13 and steps[-1] == 24
    assert tckpt.latest_step(str(tmp_path / "ck")) == 23
    assert tckpt.restore(str(tmp_path / "ck"), device="cpu")[0]["opt_state"].count == 24


def test_train_refuses_unported_options_and_datasets(tmp_path):
    # tensor parallelism is ported: a world of one runs it on a model axis of
    # 1 (the default run's losses) and refuses a mesh it does not cover
    logs = [CaptureLogger(), CaptureLogger()]
    ttr.train(_train_cfg(tmp_path, 4, tensor_parallel=True, iterations=4), logger=logs[0],
              device="cpu")
    ttr.train(_train_cfg(tmp_path, 4, iterations=4, save_dir_root=str(tmp_path / "plain")),
              logger=logs[1], device="cpu")
    losses = [[r["total_loss"] for r in log.records if "total_loss" in r] for log in logs]
    assert losses[0] and losses[0] == losses[1]
    with pytest.raises(ValueError, match="does not cover the 1 processes"):
        ttr.train(_train_cfg(tmp_path, 4, mesh_shape=(1, 2)), device="cpu")
    # the Amazon loader reads preprocessed artifacts, which this directory lacks
    with pytest.raises(FileNotFoundError, match="processed_beauty"):
        ttr.train(_train_cfg(tmp_path, 4, dataset="AMAZON", dataset_folder=str(tmp_path)),
                  device="cpu")


def test_main_parses_a_config_and_overrides(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(ttr, "train", lambda cfg: seen.setdefault("cfg", cfg))
    ttr.main([str(REPO / "configs" / "rqvae_amazon.json"), "dataset=SYNTHETIC", "iterations=5"])
    cfg = seen["cfg"]
    assert cfg.iterations == 5 and cfg.dataset.name == "SYNTHETIC" and cfg.vae_embed_dim == 32
