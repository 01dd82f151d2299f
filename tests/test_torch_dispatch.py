"""The port's kernel switch (``ops/dispatch.py``) against the JAX package on
the CPU. With ``RQVAE_TPU_DISABLE_PALLAS=1`` every route point of the port
takes JAX's route with the same variable set, which on the CPU is JAX's
default route: ``attend`` the dense ``sdpa`` at every shape,
``encode_and_tokenize`` and the stage-1 training forward the plain
per-level loop, ``children_mask`` the window gather and fold. Each case
makes every kernel wrapper and twin the route point could call raise, and
holds the port against JAX's default CPU route: fp32 values and gradients
1e-5 (of each gradient leaf's max-abs), ids equal off near-ties, masks
exactly. Unset, every route is the one it was (a twin is called), and so is
the mesh registry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu.ops import attention as jattn
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu.train import train_rqvae as jtr
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import rqvae as trq
from rqvae_tpu_torch.ops import attention as tattn
from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.parallel import mesh as tmesh
from rqvae_tpu_torch.tokenizer import semids as tsem
from rqvae_tpu_torch.train import train_rqvae as ttr

from test_torch_kernels import near_tie_rows
from test_torch_routes import _attention_case, _rq_cfgs, _rq_params
from test_torch_train_rqvae import JCAPTURE, METRICS, _CaptureGrads

ATTEND_ROUTES = ("flash_attention", "flash_attention_plain", "flash_attention_small",
                 "flash_attention_small_plain", "flash_attention_spans",
                 "flash_attention_spans_plain")


def _raise(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"{name} was called with the kernel switch off")
    return fail


def _forbid(monkeypatch, module, names):
    for name in names:
        monkeypatch.setattr(module, name, _raise(name))


def test_the_switch_is_read_at_each_call(monkeypatch):
    monkeypatch.delenv(dispatch.DISABLE_ENV, raising=False)
    assert dispatch.kernels_enabled()
    monkeypatch.setenv(dispatch.DISABLE_ENV, "1")
    assert not dispatch.kernels_enabled()
    monkeypatch.setenv(dispatch.DISABLE_ENV, "0")
    assert dispatch.kernels_enabled()


@pytest.mark.parametrize("case", ["span", "short", "flat"])
def test_attend_takes_jaxs_dense_route(case, monkeypatch):
    (q, k, v, g), kw = _attention_case(case, 64)
    monkeypatch.setenv(tattn.SHORT_FLASH_ENV, "1")   # the short route would be asked for
    monkeypatch.delenv("RQVAE_TPU_FORCE_PALLAS", raising=False)
    jkw = {name: (tuple(map(jnp.asarray, x)) if name == "q_spans" else jnp.asarray(x))
           for name, x in kw.items()}
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn.attend(jq, jk, jv, **jkw)      # JAX's default CPU route: dense
    want_grads = jax.grad(lambda *a: (jattn.attend(*a, **jkw) * jnp.asarray(g)).sum(),
                          argnums=(0, 1, 2))(jq, jk, jv)

    monkeypatch.setenv(dispatch.DISABLE_ENV, "1")
    _forbid(monkeypatch, tattn, ATTEND_ROUTES)
    tkw = {name: (tuple(map(torch.from_numpy, x)) if name == "q_spans" else torch.from_numpy(x))
           for name, x in kw.items()}
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tattn.attend(tq, tk, tv, **tkw)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for a, b in zip(grads, want_grads):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(float(np.abs(b).max()), 1.0)


def test_encode_and_tokenize_takes_the_plain_loop(monkeypatch):
    jcfg, tcfg = _rq_cfgs(64)
    p = _rq_params(jcfg)
    x = np.random.RandomState(4).randn(64, 24).astype(np.float32)
    monkeypatch.delenv("RQVAE_TPU_FORCE_PALLAS", raising=False)
    want = np.asarray(jrq.encode_and_tokenize(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x)))
    monkeypatch.setenv(dispatch.DISABLE_ENV, "1")
    _forbid(monkeypatch, trq, ("rq_tokenize", "rq_quantize_train"))
    got = trq.encode_and_tokenize(convert.from_numpy(p, device="cpu"), tcfg,
                                  torch.from_numpy(x)).numpy()
    z = np.asarray(jrq.encode(p, jcfg, jnp.asarray(x)))
    cbs = np.stack([level["codebook"] for level in p["layers"]])
    differ = (got != want).any(axis=1)
    assert not (differ & ~near_tie_rows(z, cbs, want)).any()


def test_stage1_train_step_takes_the_plain_loop(monkeypatch):
    jcfg, tcfg = _rq_cfgs(64)    # volume 65,536: the fused route when the switch is unset
    p = _rq_params(jcfg)
    x = np.random.RandomState(5).randn(1, 48, 24).astype(np.float32)
    monkeypatch.delenv("RQVAE_TPU_FORCE_PALLAS", raising=False)
    jstep = jax.jit(jtr.make_train_step(jcfg, JCAPTURE, 1, jnp.float32))
    _, jgrads, jm = jstep(jax.tree.map(jnp.asarray, p), None, jnp.asarray(x),
                          jax.random.PRNGKey(0), jnp.float32(0.2))
    monkeypatch.setenv(dispatch.DISABLE_ENV, "1")
    _forbid(monkeypatch, trq, ("rq_tokenize", "rq_quantize_train"))
    _, tgrads, tm = ttr.make_train_step(tcfg, _CaptureGrads(), 1, torch.float32)(
        convert.from_numpy(p, device="cpu"), None, torch.from_numpy(x), None, 0.2)
    for name in METRICS:
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    from rqvae_tpu_torch.utils.tree import tree_leaves_with_path

    jleaves = [np.asarray(b) for _, b in tree_leaves_with_path(jax.device_get(jgrads))]
    for (path, a), b in zip(tree_leaves_with_path(tgrads), jleaves):
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(float(np.abs(b).max()), 1e-12), path


@pytest.mark.parametrize("k", [32, 256])
def test_children_mask_takes_the_window_gather_and_fold(k, monkeypatch):
    rng = np.random.RandomState(k)
    ids = rng.randint(0, 6, size=(600, 3)).astype(np.int32)
    dedup = np.asarray(jsem.dedup_column(jnp.asarray(ids), k))
    cached = np.concatenate([ids, dedup[:, None]], axis=1)
    jidx = jsem.build_index(jnp.asarray(cached), codebook_size=k)
    tidx = tsem.build_index(torch.from_numpy(cached), k)
    monkeypatch.setenv(dispatch.DISABLE_ENV, "1")
    _forbid(monkeypatch, tsem, ("children_window_mask",))
    for length in (0, 1, 2, 3):
        prefix = (np.zeros((2, 0), np.int32) if length == 0 else np.concatenate(
            [cached[:30, :length], rng.randint(0, 8, size=(18, length))]).astype(np.int32))
        want = np.asarray(jsem.children_mask(jidx, jnp.asarray(prefix)))
        got = tsem.children_mask(tidx, torch.from_numpy(prefix)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("value", [None, "0"])
def test_unset_every_route_is_unchanged(value, monkeypatch):
    if value is None:
        monkeypatch.delenv(dispatch.DISABLE_ENV, raising=False)
    else:
        monkeypatch.setenv(dispatch.DISABLE_ENV, value)
    monkeypatch.setenv(tattn.SHORT_FLASH_ENV, "1")
    calls = []

    def spy(module, name):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: calls.append(name) or real(*a, **k))

    for name in ("flash_attention_plain", "flash_attention_small_plain",
                 "flash_attention_spans_plain"):
        spy(tattn, name)
    spy(trq, "rq_tokenize")
    spy(trq, "rq_quantize_train")
    spy(tsem, "children_window_mask")
    for case in ("span", "short", "flat"):
        (q, k, v, _), kw = _attention_case(case, 64)
        tkw = {n: (tuple(map(torch.from_numpy, x)) if n == "q_spans" else torch.from_numpy(x))
               for n, x in kw.items()}
        tattn.attend(*map(torch.from_numpy, (q, k, v)), **tkw)
    jcfg, tcfg = _rq_cfgs(64)
    tp = convert.from_numpy(_rq_params(jcfg), device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).randn(16, 24).astype(np.float32))
    trq.encode_and_tokenize(tp, tcfg, x)
    trq.forward(tp, tcfg, x, gumbel_t=0.2, training=True)
    tidx = tsem.build_index(torch.from_numpy(np.array([[0, 1, 0, 0], [1, 0, 0, 0]], np.int32)), 4)
    tsem.children_mask(tidx, torch.zeros((1, 1), dtype=torch.int32))
    assert calls == ["flash_attention_spans_plain", "flash_attention_small_plain",
                     "flash_attention_plain", "rq_tokenize", "rq_quantize_train",
                     "children_window_mask"]


def test_mesh_registry_and_local_execution():
    saved = dispatch.execution_mesh()
    try:
        dispatch.set_execution_mesh(None)
        assert dispatch.divisible_over_data(3) and dispatch.model_axis_size() == 1
        dispatch.set_execution_mesh(tmesh.Mesh(data=2))
        assert dispatch.execution_mesh().size == 2
        assert dispatch.divisible_over_data(4, heads=8) and not dispatch.divisible_over_data(3)
        with dispatch.local_execution():
            assert dispatch.execution_mesh() is None and dispatch.divisible_over_data(3)
        assert dispatch.execution_mesh() == tmesh.Mesh(data=2)
    finally:
        dispatch.set_execution_mesh(saved)
