"""The port's packed long-context training path against the JAX package, on
the CPU: the span mask and ``attend(q_spans=...)``, the span kernels' plain
twins against the Pallas span kernel in interpret mode, the packer and the
crop sampler, ``tokenize_packed``, the packed model and ``make_packed_step``.

The model config reaches the span route: 64-item capacity x D = 4 plus 4
user tokens is 260 encoder tokens, and attn_dim 128 over 2 heads gives
Dh = 64. Parameters come from the JAX ``retrieval.init`` and cross as numpy;
inputs are numpy-seeded; fp32, dropout 0 (dropout noise cannot be
bit-matched across frameworks). On the CPU the JAX package takes its dense
jnp attention everywhere (no Pallas off the TPU) while the port's encoder
takes the span twin, so the forward tests also hold twin against dense.

Tolerances: the twins against the Pallas kernel 2e-5 on values and 1e-4 on
gradients (the JAX tests' own); integers exactly; embeddings 1e-6; losses
1e-5 relative; gradient leaves 1e-4 of their max-abs (fp32 sums in other
orders over two layers); parameters after one AdamW step 1e-5.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data import dataset as jdataset
from rqvae_tpu.data import packing as jpacking
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.ops import attention as jattn
from rqvae_tpu.ops import flash_attention as jfa
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu.train import optim as joptim
from rqvae_tpu.train import train_decoder as jtd
from rqvae_tpu.utils import config as jconfig
from rqvae_tpu_torch.data import dataset as tdataset
from rqvae_tpu_torch.data import packing as tpacking
from rqvae_tpu_torch.data.schemas import SeqBatch as TSeqBatch
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import retrieval as tret
from rqvae_tpu_torch.ops import attention as tattn
from rqvae_tpu_torch.ops import flash_attention as tfa
from rqvae_tpu_torch.tokenizer import semids as tsem
from rqvae_tpu_torch.train import optim as toptim
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path, tree_map

K = 16
N_ITEMS = 60
CAP = 64        # items a packed row holds
SLOTS = 4
JCFG = jret.RetrievalConfig(
    embedding_dim=16, attn_dim=128, dropout=0.0, num_heads=2, n_layers=2, num_embeddings=K,
    sem_id_dim=4, max_pos=CAP * 4, input_dropout=0.0, mlp_hidden_dim=64,
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


def _crops(n, seed, min_len=2, max_len=CAP):
    rng = np.random.RandomState(seed)
    return [(int(rng.randint(0, 5000)), rng.randint(0, N_ITEMS, rng.randint(min_len, max_len + 1))
             .astype(np.int32), int(rng.randint(0, N_ITEMS))) for _ in range(n)]


def _pack(crops, rows, slots=SLOTS):
    """The same packed batch for both packages (the port's packer; its
    placement equals JAX's, tested below)."""
    batch, _ = tpacking.pack_crops(crops, rows=rows, slots=slots, capacity=CAP)
    jb = jpacking.PackedSeqBatch(*(jnp.asarray(a) for a in batch))
    return jb, tpacking.to_device(batch, "cpu")


CROPS = _crops(9, seed=1, min_len=3, max_len=30)   # several segments a row, one unused slot


def _leaves(tree):
    return [(p, np.asarray(x.detach() if isinstance(x, torch.Tensor) else x))
            for p, x in tree_leaves_with_path(tree)]


def _assert_leaves_close(got, want, rel=1e-4):
    got, want = _leaves(got), _leaves(jax.device_get(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        scale = max(float(np.abs(b).max()), 1e-12)
        assert np.abs(a - b).max() <= rel * scale, (path, float(np.abs(a - b).max()), scale)


# ---------------------------------------------------------------------------
# span mask, attend, the span twins
# ---------------------------------------------------------------------------

def _spans(rng, b, nq, nk):
    """Random bounds with JAX's test mix: fully masked rows (lo = hi = 0,
    extra = -1), window-only rows, extra columns in and outside windows."""
    lo = rng.randint(0, max(1, nk - 40), (b, nq)).astype(np.int32)
    hi = lo + rng.randint(0, 40, (b, nq)).astype(np.int32)
    extra = rng.randint(-1, nk, (b, nq)).astype(np.int32)
    lo[:, :5] = 0
    hi[:, :5] = 0
    extra[:, :3] = -1
    return lo, hi, extra


@pytest.mark.parametrize("causal,with_k_mask", [(False, False), (True, False), (False, True)])
def test_span_mask_and_build_mask_match_jax(causal, with_k_mask):
    rng = np.random.RandomState(2)
    b, nq, nk = 3, 11, 29
    spans = _spans(rng, b, nq, nk)
    k_mask = rng.rand(b, nk) < 0.7 if with_k_mask else None
    want = jattn.build_mask(nq, nk, causal=causal, q_spans=tuple(map(jnp.asarray, spans)),
                            k_mask=None if k_mask is None else jnp.asarray(k_mask))
    got = tattn.build_mask(nq, nk, causal=causal, q_spans=tuple(map(torch.from_numpy, spans)),
                           k_mask=None if k_mask is None else torch.from_numpy(k_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tattn.span_mask(tuple(map(torch.from_numpy, spans)), nk).numpy(),
                                  np.asarray(jattn.span_mask(tuple(map(jnp.asarray, spans)), nk)))


def test_span_mask_semantics():
    m = tattn.span_mask((torch.tensor([[1, 0]]), torch.tensor([[3, 0]]), torch.tensor([[4, -1]])), 5)
    assert m[0, 0].tolist() == [False, True, True, False, True]
    assert m[0, 1].tolist() == [False] * 5   # lo = hi = 0, extra = -1: attends nothing


def _numeric_state():
    """The process-wide settings that decide fp32 results on the CPU."""
    return dict(torch_threads=torch.get_num_threads(),
                torch_matmul=torch.get_float32_matmul_precision(),
                jax_matmul=str(jax.config.jax_default_matmul_precision),
                jax_x64=bool(jax.config.jax_enable_x64), xla_flags=os.environ.get("XLA_FLAGS", ""),
                omp_threads=os.environ.get("OMP_NUM_THREADS"))


def _span_attention_f64(q, k, v, spans, g):
    """Span attention and its (dq, dk, dv) for ``g`` in float64: the
    reference that tells which side of a parity failure moved."""
    q, k, v = (torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v))
    allow = tattn.span_mask(tuple(map(torch.from_numpy, spans)), k.shape[2])[:, None]
    s = torch.where(allow, q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1e300)
    e = torch.exp(s - s.amax(-1, keepdim=True).detach()) * allow
    out = (e @ v) / e.sum(-1, keepdim=True).clamp_min(1e-300)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g).double())
    return out.detach().numpy(), [t.numpy() for t in grads]


def _sides(want, got, ref):
    """How far each side lies from the float64 reference."""
    return (f"max |JAX kernel - float64| {np.abs(np.asarray(want) - ref).max():.3e}, "
            f"max |port twin - float64| {np.abs(np.asarray(got) - ref).max():.3e}")


# JAX's cases (tests/test_packing.py: 70 x 70), plus Nq != Nk and Nq not a
# multiple of 64 on either side. A failure names the side that moved against
# a float64 reference, and the settings printed first name the state.
@pytest.mark.parametrize("nq,nk", [(70, 70), (70, 100), (130, 67)])
def test_span_twins_match_jax_kernel(nq, nk):
    print("numeric state:", _numeric_state())
    rng = np.random.RandomState(0)
    b, h, dh = 2, 2, 64
    q, k, v = (rng.randn(b, h, n, dh).astype(np.float32) for n in (nq, nk, nk))
    spans = _spans(rng, b, nq, nk)
    g = rng.randn(b, h, nq, dh).astype(np.float32)
    jspans = tuple(map(jnp.asarray, spans))

    def jflash(q_, k_, v_):
        return jfa.flash_attention_spans(q_, k_, v_, *jspans, interpret=True)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jflash(jq, jk, jv)
    want_grads = jax.grad(lambda *a: (jflash(*a) * jnp.asarray(g)).sum(), argnums=(0, 1, 2))(jq, jk, jv)

    tspans = tuple(map(torch.from_numpy, spans))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tfa.flash_attention_spans_plain(tq, tk, tv, *tspans)
    ref, ref_grads = _span_attention_f64(q, k, v, spans, g)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5,
                               err_msg=_sides(want, got.detach(), ref))
    np.testing.assert_array_equal(got[:, :, :3].detach().numpy(), 0.0)   # fully masked rows
    autograd = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    twin = tfa.flash_attention_spans_bwd_plain(tq.detach(), tk.detach(), tv.detach(), *tspans,
                                               torch.from_numpy(g))
    # the autograd.Function route (the wrappers run the twins on the CPU)
    fq, fk, fv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    fn_out = tfa.flash_attention_spans(fq, fk, fv, *tspans)
    np.testing.assert_array_equal(fn_out.detach().numpy(), got.detach().numpy())
    function = torch.autograd.grad(fn_out, (fq, fk, fv), torch.from_numpy(g))
    for grads in (autograd, twin, function):
        for a, b_, r in zip(grads, want_grads, ref_grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4, atol=1e-4,
                                       err_msg=_sides(b_, a, r))


def test_span_wrappers_check_bounds_and_count_no_launch_on_the_cpu():
    q = torch.randn(1, 2, 8, 64)
    lo = torch.zeros(1, 8, dtype=torch.int32)
    before = (tfa.flash_attention_spans_fwd.launches, tfa.flash_attention_spans_bwd.launches)
    out, m, inv = tfa.flash_attention_spans_fwd(q, q, q, lo, lo + 8, lo - 1)
    tfa.flash_attention_spans_bwd(q, q, q, lo, lo + 8, lo - 1, out, m, inv)
    assert (tfa.flash_attention_spans_fwd.launches,
            tfa.flash_attention_spans_bwd.launches) == before   # the CPU runs the twins
    with pytest.raises(ValueError, match="expected"):
        tfa.flash_attention_spans_fwd(q, q, q, lo[:, :4], lo, lo)
    with pytest.raises(TypeError, match="integer"):
        tfa.flash_attention_spans_fwd(q, q, q, lo.float(), lo, lo)


@pytest.mark.parametrize("n,route", [(260, "kernel"), (40, "dense")])
def test_attend_with_spans_matches_jax_and_routes_by_length(n, route, monkeypatch):
    rng = np.random.RandomState(3)
    b, h, dh = 2, 2, 64
    q, k, v = (rng.randn(b, n, h, dh).astype(np.float32) for _ in range(3))
    spans = _spans(rng, b, n, n)
    want = jattn.attend(*map(jnp.asarray, (q, k, v)), q_spans=tuple(map(jnp.asarray, spans)))
    calls = []
    real = tfa.flash_attention_spans_plain
    monkeypatch.setattr(tattn, "flash_attention_spans_plain",
                        lambda *a: calls.append(1) or real(*a))
    got = tattn.attend(*map(torch.from_numpy, (q, k, v)), q_spans=tuple(map(torch.from_numpy, spans)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert bool(calls) == (route == "kernel")


# ---------------------------------------------------------------------------
# packer and crop sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,rows,slots,max_len", [(17, 6, 4, 12), (40, 5, 8, 30), (9, 3, 4, 64)])
def test_pack_crops_places_like_jax(n, rows, slots, max_len):
    crops = _crops(n, seed=n, max_len=max_len)
    want, want_left = jpacking.pack_crops(crops, rows=rows, slots=slots, capacity=CAP)
    got, got_left = tpacking.pack_crops(crops, rows=rows, slots=slots, capacity=CAP)
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert [id(c) for c in got_left] == [id(c) for c in want_left]


def test_pack_crops_raises_on_a_crop_longer_than_the_capacity():
    crops = _crops(4, seed=5, max_len=10) + [(1, np.arange(CAP + 1, dtype=np.int32), 2)]
    with pytest.raises(ValueError, match="longer than the capacity"):
        tpacking.pack_crops(crops, rows=2, slots=4, capacity=CAP)


def _seq_datasets(seed=0, n_users=30, stored=16, max_seq_len=12):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, stored + 1, n_users)
    item_ids = np.full((n_users, stored), -1, np.int32)
    for i, ln in enumerate(lens):
        item_ids[i, :ln] = rng.integers(0, N_ITEMS, ln)
    arrays = dict(user_ids=np.arange(n_users, dtype=np.int32), item_ids=item_ids,
                  item_ids_fut=rng.integers(0, N_ITEMS, (n_users, 1)).astype(np.int32),
                  max_seq_len=max_seq_len)
    return jdataset.SeqDataset(**arrays), tdataset.SeqDataset(**arrays)


def test_subsample_row_and_batch_at_match_jax():
    jseqs, tseqs = _seq_datasets()
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(len(tseqs)):
        for _ in range(3):
            w_ids, w_fut = jseqs._subsample_row(jrng, jseqs.item_ids[i], int(jseqs.item_ids_fut[i, 0]))
            g_ids, g_fut = tseqs._subsample_row(trng, tseqs.item_ids[i], int(tseqs.item_ids_fut[i, 0]))
            np.testing.assert_array_equal(g_ids, w_ids)
            assert g_fut == w_fut
    idx = np.array([3, 0, 29, 3])
    for name, a in tseqs.batch_at(idx).items():   # no crop: the last max_seq_len items
        np.testing.assert_array_equal(a, jseqs.batch_at(idx)[name], err_msg=name)


def test_packer_streaming_places_every_sampled_crop_once():
    _, seqs = _seq_datasets(seed=1)
    packer = tpacking.SequencePacker(seqs=seqs, rng=np.random.default_rng(0), rows=4, slots=4)
    sampled = []
    real = packer._sample_crops
    packer._sample_crops = lambda count: sampled.extend(real(count)) or sampled[-count:]
    key = lambda c: (c[0], c[2], tuple(int(x) for x in c[1]))  # noqa: E731
    placed, fills = [], []
    for _ in range(8):
        batch, n = packer.next_batch()
        assert n == int(batch.slot_valid.sum()) and n >= 4
        for r, s in zip(*np.nonzero(batch.slot_valid)):
            st, ln = int(batch.slot_start[r, s]), int(batch.slot_len[r, s])
            assert (batch.seg_item[r, st:st + ln] == s).all()
            placed.append((int(batch.user_ids[r, s]), batch.ids[r, st:st + ln].copy(),
                           int(batch.ids_fut[r, s])))
        fills.append((batch.ids >= 0).mean())
    assert sorted(map(key, placed + packer._pending)) == sorted(map(key, sampled))
    assert np.mean(fills) > 0.7   # far above one example per row


# ---------------------------------------------------------------------------
# tokenizer, spans, embeddings
# ---------------------------------------------------------------------------

def test_tokenize_packed_and_spans_match_jax(setup):
    jindex, tindex, _, _ = setup
    jb, tb = _pack(CROPS, rows=3)
    want, got = jsem.tokenize_packed(jindex, jb), tsem.tokenize_packed(tindex, tb)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert not bool(got.slot_valid.all())   # an unused slot's spans are checked too
    for sw, sg in zip(jret.packed_spans(JCFG, want), tret.packed_spans(TCFG, got)):
        for a, b in zip(sg, sw):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_embed_packed_match_jax(setup):
    jindex, tindex, jp, tp = setup
    jb, tb = _pack(CROPS, rows=3)
    jtok, ttok = jsem.tokenize_packed(jindex, jb), tsem.tokenize_packed(tindex, tb)
    for jfn, tfn in ((jret.embed_packed_context, tret.embed_packed_context),
                     (jret.embed_packed_future, tret.embed_packed_future)):
        np.testing.assert_allclose(tfn(tp, TCFG, ttok).numpy(), np.asarray(jfn(jp, JCFG, jtok)),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the packed model and step
# ---------------------------------------------------------------------------

def test_forward_packed_loss_and_gradients_match_jax(setup, monkeypatch):
    jindex, tindex, jp, tp = setup
    jb, tb = _pack(CROPS, rows=3)
    jtok, ttok = jsem.tokenize_packed(jindex, jb), tsem.tokenize_packed(tindex, tb)
    assert ttok.sem_ids.shape[1] + SLOTS == 260   # the encoder takes the span route
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o.loss, o))(jret.forward_packed(p, JCFG, jtok)), has_aux=True))(jp)
    calls = []
    real = tfa.flash_attention_spans_plain
    monkeypatch.setattr(tattn, "flash_attention_spans_plain", lambda *a: calls.append(1) or real(*a))
    tloss, tout, tgrads = ttd.value_and_grad(
        lambda p: (lambda o: (o.loss, o))(tret.forward_packed(p, TCFG, ttok)), tp)
    assert len(calls) == TCFG.n_layers // 2   # one encoder layer: the span twin
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tout.loss_d.numpy(), np.asarray(jout.loss_d), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), rtol=1e-5, atol=1e-5)
    _assert_leaves_close(tgrads, jgrads)


def test_make_packed_step_matches_jax_with_optax(setup):
    jindex, tindex, jp, tp = setup
    jb, tb = _pack(CROPS, rows=3)
    jopt = joptim.adamw(1e-3, 0.035)
    jstep = jax.jit(jtd.make_packed_step(JCFG, jopt, jindex, jnp.float32))
    jparams, _, jm = jstep(jp, jopt.init(jp), jb, jax.random.key(0))
    topt = toptim.adamw(1e-3, 0.035)
    tparams = tree_map(lambda t: t.clone(), tp)
    tstep = ttd.make_packed_step(TCFG, topt, tindex, torch.float32)
    tparams, state, tm = tstep(tparams, topt.init(tparams), tb, torch.Generator().manual_seed(0))
    assert state.count == 1
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["loss_d"].numpy(), np.asarray(jm["loss_d"]), rtol=1e-5, atol=1e-6)
    moved = 0.0
    for (path, a), (_, b), (_, p0) in zip(_leaves(tparams), _leaves(jax.device_get(jparams)),
                                          _leaves(tp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=str(path))
        moved = max(moved, float(np.abs(a - p0).max()))
    assert moved > 5e-4   # the step really moved the parameters (lr 1e-3)


def _flat_tok(crops, tindex, n_hist=CAP):
    b = len(crops)
    ids = np.full((b, n_hist), -1, np.int32)
    for i, (_, crop, _) in enumerate(crops):
        ids[i, :len(crop)] = crop
    arrays = dict(user_ids=np.asarray([c[0] for c in crops], np.int32), ids=ids,
                  ids_fut=np.asarray([[c[2]] for c in crops], np.int32),
                  x=np.zeros((b, n_hist, 1), np.float32), x_fut=np.zeros((b, 1, 1), np.float32),
                  seq_mask=ids >= 0)
    return tsem.tokenize_sequences(tindex, TSeqBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("rows,slots,max_len", [(5, 1, CAP), (3, 4, 20)])
def test_packed_equals_the_flat_batch_mean(setup, rows, slots, max_len):
    """One crop a row is the flat layout; several a row equal the flat batch
    mean over the same examples: loss, loss_d and gradients."""
    _, tindex, _, tp = setup
    crops = _crops(rows if slots == 1 else 7, seed=11, min_len=3, max_len=max_len)
    batch, left = tpacking.pack_crops(crops, rows=rows, slots=slots, capacity=CAP)
    assert not left and int(batch.slot_valid.sum()) == len(crops)
    ptok = tsem.tokenize_packed(tindex, tpacking.to_device(batch, "cpu"))
    ftok = _flat_tok(crops, tindex)
    fl, fo, fg = ttd.value_and_grad(lambda p: (lambda o: (o.loss, o.loss_d))(
        tret.forward(p, TCFG, ftok)), tp)
    pl, po, pg = ttd.value_and_grad(lambda p: (lambda o: (o.loss, o.loss_d))(
        tret.forward_packed(p, TCFG, ptok)), tp)
    np.testing.assert_allclose(float(pl), float(fl), rtol=1e-5)
    np.testing.assert_allclose(po.numpy(), fo.numpy(), rtol=1e-4, atol=1e-6)
    for (path, a), (_, b) in zip(_leaves(pg), _leaves(fg)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(float(np.abs(b).max()), 1e-12),
                                   err_msg=str(path))


def test_packed_segments_are_isolated(setup):
    """Changing one segment's tokens leaves every other slot's loss as it
    was, in its own row too (no attention across segments)."""
    _, tindex, _, tp = setup
    crops = _crops(8, seed=12, min_len=3, max_len=20)
    batch, _ = tpacking.pack_crops(crops, rows=3, slots=SLOTS, capacity=CAP)
    tok = tsem.tokenize_packed(tindex, tpacking.to_device(batch, "cpu"))

    def slot_losses(t):
        out = tret.forward_packed(tp, TCFG, t)
        tgt = torch.where(t.slot_valid[:, :, None], t.sem_ids_fut, -1)
        return tret.cross_entropy_ignore(out.logits, tgt).sum(-1).detach().numpy()

    r, s = 0, 0
    assert bool(tok.slot_valid[r, s]) and int(tok.slot_valid[r].sum()) > 1
    st, ln = int(tok.slot_start[r, s]) * 4, int(tok.slot_len[r, s]) * 4
    sem = tok.sem_ids.clone()
    sem[r, st:st + ln] = (sem[r, st:st + ln] + 1) % K
    base, pert = slot_losses(tok), slot_losses(tok._replace(sem_ids=sem))
    assert abs(base[r, s] - pert[r, s]) > 1e-6
    other = tok.slot_valid.numpy().copy()
    other[r, s] = False
    np.testing.assert_allclose(pert[other], base[other], rtol=0, atol=1e-6)


def test_training_dropout_draws_from_the_generator(setup):
    _, tindex, _, tp = setup
    _, tb = _pack(CROPS, rows=3)
    tok = tsem.tokenize_packed(tindex, tb)
    cfg = dataclasses.replace(TCFG, dropout=0.3, input_dropout=0.5)
    losses = [float(tret.forward_packed(tp, cfg, tok, training=True,
                                        generator=torch.Generator().manual_seed(s)).loss)
              for s in (1, 1, 2)]
    assert all(np.isfinite(losses)) and losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="Generator"):
        tret.forward_packed(tp, cfg, tok, training=True)


def test_load_config_reads_the_packed_fields_as_jax():
    over = ["packed_rows=96", "pack_slots=6"]
    want = jconfig.load_config(jtd.DecoderTrainConfig, None, over)
    got = tconfig.load_config(ttd.DecoderTrainConfig, None, over)
    assert (got.packed_rows, got.pack_slots) == (want.packed_rows, want.pack_slots) == (96, 6)
    assert (ttd.DecoderTrainConfig().packed_rows, ttd.DecoderTrainConfig().pack_slots) == (
        jtd.DecoderTrainConfig().packed_rows, jtd.DecoderTrainConfig().pack_slots)
