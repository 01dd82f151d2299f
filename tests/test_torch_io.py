"""The port's model export / import (``rqvae_tpu_torch.models.io``) on the
CPU: round trips of both model families, semantic IDs equal after a reload,
the JAX package's ``save_pretrained`` directories read by the port, the hub
wrappers against fakes of ``HfApi`` / ``snapshot_download`` (nothing touches
the network), and ``train_decoder.train(push_vae_to_hf=True)`` exporting the
frozen RQ-VAE and pushing it through the fake."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from rqvae_tpu.models import io as jio
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu_torch.models import io as tio
from rqvae_tpu_torch.models import retrieval as tret
from rqvae_tpu_torch.models import rqvae as trq
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path

RQ = dict(input_dim=18, embed_dim=8, hidden_dims=(16,), codebook_size=16, n_layers=2,
          n_cat_feats=0)
RET = dict(embedding_dim=8, attn_dim=16, dropout=0.0, num_heads=2, n_layers=2,
           num_embeddings=16, sem_id_dim=3, max_pos=12, mlp_hidden_dim=32)


def _assert_trees_equal(a, b):
    pa, pb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


@pytest.mark.parametrize("mode", ["GUMBEL_SOFTMAX", "ROTATION_TRICK"])
def test_rqvae_roundtrip(tmp_path, mode):
    cfg = trq.RqVaeConfig(**RQ, codebook_mode=QuantizeForwardMode[mode])
    params = trq.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = str(tmp_path / "m")
    assert tio.save_pretrained(path, params, cfg) == path
    with open(os.path.join(path, "model_config.json")) as f:
        meta = json.load(f)
    assert meta["kind"] == "rqvae" and meta["config"]["codebook_mode"] == mode
    params2, cfg2 = tio.load_pretrained(path, device="cpu")
    assert cfg2 == cfg
    _assert_trees_equal(params, params2)
    x = torch.randn(32, 18, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(trq.encode_and_tokenize(params, cfg, x).numpy(),
                                  trq.encode_and_tokenize(params2, cfg2, x).numpy())


def test_retrieval_roundtrip(tmp_path):
    cfg = tret.RetrievalConfig(**RET)
    params = tret.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    tio.save_pretrained(str(tmp_path / "d"), params, cfg)
    params2, cfg2 = tio.load_pretrained(str(tmp_path / "d"), device="cpu")
    assert cfg2 == cfg
    _assert_trees_equal(params, params2)


def test_the_port_writes_the_jax_config_schema(tmp_path):
    """model_config.json holds what the JAX package writes for the same
    config: {"kind", "config"} with the same keys and values."""
    for jcfg, tcfg, init in ((jrq.RqVaeConfig(**RQ), trq.RqVaeConfig(**RQ), trq.init),
                             (jret.RetrievalConfig(**RET), tret.RetrievalConfig(**RET), tret.init)):
        jpath, tpath = tmp_path / f"j_{type(jcfg).__name__}", tmp_path / f"t_{type(jcfg).__name__}"
        jinit = jrq.init if isinstance(jcfg, jrq.RqVaeConfig) else jret.init
        jio.save_pretrained(str(jpath), jinit(jax.random.PRNGKey(0), jcfg), jcfg)
        tio.save_pretrained(str(tpath), init(torch.Generator(), tcfg, device="cpu"), tcfg)
        want = json.loads((jpath / "model_config.json").read_text())
        got = json.loads((tpath / "model_config.json").read_text())
        assert got == want


@pytest.mark.parametrize("kind", ["rqvae", "retrieval"])
def test_load_pretrained_reads_a_jax_directory(tmp_path, kind):
    if kind == "rqvae":
        jcfg = jrq.RqVaeConfig(**RQ, codebook_mode=jrq.QuantizeForwardMode.ROTATION_TRICK)
        jp = jrq.init(jax.random.PRNGKey(3), jcfg)
    else:
        jcfg = jret.RetrievalConfig(**RET)
        jp = jret.init(jax.random.PRNGKey(4), jcfg)
    jio.save_pretrained(str(tmp_path / "j"), jp, jcfg)
    params, cfg = tio.load_pretrained(str(tmp_path / "j"), device="cpu")
    assert type(cfg).__module__.startswith("rqvae_tpu_torch")
    assert tconfig.config_to_dict(cfg) == json.loads(
        (tmp_path / "j" / "model_config.json").read_text())["config"]
    _assert_trees_equal(params, jax.device_get(jp))
    # the port's own export of what it read round-trips to the same leaves
    tio.save_pretrained(str(tmp_path / "t"), params, cfg)
    _assert_trees_equal(tio.load_pretrained(str(tmp_path / "t"), device="cpu")[0], params)


def test_load_pretrained_rejects_params_that_do_not_fit(tmp_path):
    cfg = trq.RqVaeConfig(**RQ)
    tio.save_pretrained(str(tmp_path / "m"), trq.init(torch.Generator(), cfg, device="cpu"), cfg)
    meta = json.loads((tmp_path / "m" / "model_config.json").read_text())
    meta["config"]["embed_dim"] = 4
    (tmp_path / "m" / "model_config.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="do not fit"):
        tio.load_pretrained(str(tmp_path / "m"), device="cpu")
    with pytest.raises(TypeError, match="unsupported config"):
        tio.save_pretrained(str(tmp_path / "x"), {}, object())


def test_load_pretrained_needs_cuda_unless_cpu_requested(tmp_path, monkeypatch):
    cfg = trq.RqVaeConfig(**RQ)
    tio.save_pretrained(str(tmp_path / "m"), trq.init(torch.Generator(), cfg, device="cpu"), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_pretrained(str(tmp_path / "m"))


def _export(tmp_path, name="export"):
    cfg = trq.RqVaeConfig(**RQ)
    params = trq.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = str(tmp_path / name)
    tio.save_pretrained(path, params, cfg)
    return path, params, cfg


class FakeApi:
    calls = {}

    def __init__(self, token=None):
        FakeApi.calls = {"token": token}

    def create_repo(self, repo_id, private, exist_ok):
        FakeApi.calls["create"] = (repo_id, private, exist_ok)

    def upload_folder(self, folder_path, repo_id):
        FakeApi.calls["upload"] = (folder_path, repo_id)


def test_push_to_hub_uploads_export_dir(tmp_path, monkeypatch):
    import huggingface_hub

    export, _, _ = _export(tmp_path)
    monkeypatch.setattr(huggingface_hub, "HfApi", FakeApi)
    assert tio.push_to_hub(export, "me/rqvae-test", token="t0") == "https://huggingface.co/me/rqvae-test"
    assert FakeApi.calls == {"token": "t0", "create": ("me/rqvae-test", True, True),
                             "upload": (export, "me/rqvae-test")}


def test_push_to_hub_unreachable_is_a_runtime_error(tmp_path, monkeypatch):
    import huggingface_hub

    class Offline(FakeApi):
        def create_repo(self, repo_id, private, exist_ok):
            raise ConnectionError("no route to host")

    export, _, _ = _export(tmp_path)
    monkeypatch.setattr(huggingface_hub, "HfApi", Offline)
    with pytest.raises(RuntimeError, match="no route to host"):
        tio.push_to_hub(export, "me/rqvae-test")


def test_load_pretrained_auto_hub_fallback(tmp_path, monkeypatch):
    import huggingface_hub

    export, params, cfg = _export(tmp_path, "snapshot")

    def fake_snapshot(repo, token=None, revision=None):
        assert (repo, revision) == ("me/rqvae-test", "main")
        return export

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot)
    params2, cfg2 = tio.load_pretrained_auto("me/rqvae-test", revision="main", device="cpu")
    assert cfg2 == cfg
    _assert_trees_equal(params, params2)
    # a local directory never reaches the hub
    monkeypatch.setattr(huggingface_hub, "snapshot_download", None)
    params3, cfg3 = tio.load_pretrained_auto(export, device="cpu")
    assert cfg3 == cfg
    _assert_trees_equal(params, params3)


def test_load_pretrained_auto_unreachable_is_a_runtime_error(tmp_path, monkeypatch):
    import huggingface_hub

    def offline(repo, token=None, revision=None):
        raise OSError("offline")

    monkeypatch.setattr(huggingface_hub, "snapshot_download", offline)
    with pytest.raises(RuntimeError, match="neither a local save_pretrained directory"):
        tio.load_pretrained_auto(str(tmp_path / "nowhere"), device="cpu")


def test_train_exports_and_pushes_the_frozen_rqvae(tmp_path, monkeypatch):
    """``push_vae_to_hf``: after corpus tokenization, before the first step,
    train() writes <save_dir_root>/rqvae_export and pushes it to
    ``vae_hf_model_name``. The export holds the frozen RQ-VAE."""
    import huggingface_hub

    monkeypatch.setattr(huggingface_hub, "HfApi", FakeApi)
    steps = []
    real_step = ttd.make_train_step

    def make_step(*a, **kw):
        step = real_step(*a, **kw)

        def counted(*sa, **skw):
            steps.append(os.path.isdir(tmp_path / "dec" / "rqvae_export"))
            return step(*sa, **skw)

        return counted

    monkeypatch.setattr(ttd, "make_train_step", make_step)
    cfg = tconfig.from_dict(ttd.DecoderTrainConfig, dict(
        dataset="SYNTHETIC", vae_input_dim=16, vae_hidden_dims=(16,), vae_embed_dim=8,
        vae_codebook_size=16, vae_n_cat_feats=0, vae_n_layers=3, synthetic_n_items=64,
        synthetic_n_users=32, iterations=2, batch_size=4, attn_embed_dim=32, attn_heads=2,
        attn_layers=2, decoder_embed_dim=8, log_every=100, partial_eval_every=0,
        full_eval_every=0, generation_top_k=4, generation_candidates=16, save_model_every=10**9,
        save_dir_root=str(tmp_path / "dec"),
        push_vae_to_hf=True, vae_hf_model_name="me/frozen-rqvae"))
    ttd.train(cfg, device="cpu")
    export = str(tmp_path / "dec" / "rqvae_export")
    assert steps == [True, True]
    assert FakeApi.calls["create"] == ("me/frozen-rqvae", True, True)
    assert FakeApi.calls["upload"] == (export, "me/frozen-rqvae")
    params, vae_cfg = tio.load_pretrained(export, device="cpu")
    want, want_cfg = ttd.load_frozen_rqvae(cfg, device="cpu")
    assert vae_cfg == want_cfg
    _assert_trees_equal(params, want)
    assert all(not t.requires_grad for t in tree_leaves(params))
