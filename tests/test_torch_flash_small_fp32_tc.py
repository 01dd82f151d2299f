"""The fp32 short-sequence kernels' arithmetic on the tensor cores
(``csrc/flash_attention_small_fwd.cu``: ``small_fwd_tf32_kernel``;
``csrc/flash_attention_small_bwd.cu``: ``small_bwd_tf32_kernel``), emulated
in torch on the CPU, against the plain twins and the JAX package's
``flash_attention_small`` in interpret mode, and the Python restatement of
the libraries' route gates (``flash_attention.small_route``).

The emulation follows the kernels' order of operations: every product as
three TF32 products (TF32 rounding by bit arithmetic, round to nearest and
ties away on the 13 dropped bits as ``cvt.rna.tf32.f32``; each operand split
into big = tf32(x) and small = tf32(x - big); small x big + big x small +
big x big, fp32 accumulation, no operand rounded to a narrower type);
live key tiles only (a 16-key tile is live when one of its keys has a bias
above -5e29; under the causal cut a query tile takes those at or below its
last row); the forward's one max and one sum over the whole row in log2
units, m stored as m2 ln 2 (-1e30 for a row that met no valid key) and
inv = 0 exactly there; the backward reading those m and inv, with the
exact c = rowsum(dp * e) inv over the whole row, ds = e ((dp - c) inv),
dq = ds k scale, dk = ds^T q scale, dv = e^T (g inv), over query chunks of
at most 96 rows and strips of at most four live tiles: where a row's live
tiles need more than one strip, c comes from a first sweep over every
strip, each strip adds its dq to the previous strips' sum and each chunk
its dk, dv to the previous chunks'; keys in no live tile get dk = dv = 0.

Inputs are numpy-seeded fp32 at small batch versions of the shapes the
shipped decoder configs give the kernels with ``RQVAE_TPU_SHORT_FLASH=1``
(81 x 81 under a right-padded key mask, causal 5 x 5, 5 x 81, the beam
search's 32 x 81 and a decode step's 1 x 7), a dead middle key tile, two
batch rows with no valid key, and shapes with several strips (Nk > 96,
causal too) and several query chunks (Nq > 96). The bound is the kernels' own against their twins on the card,
1e-4 (absolute and relative); rows with no valid key give zeros exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import flash_attention as jfa
from rqvae_tpu_torch.ops import flash_attention as tfa

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TILE = 16
STRIP = 4   # live key tiles a strip of the backward (csrc: kTf32Strip)
CHUNK = 96  # query rows a chunk of the backward (csrc: kTf32Chunk)
TOL = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (kept as fp32): round to nearest, ties away from zero,
    on the 13 dropped mantissa bits (the sign-magnitude bits carry)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products with fp32 accumulation."""
    ab, bb = tf32(a), tf32(b)
    return tf32(a - ab) @ bb + ab @ tf32(b - bb) + ab @ bb


def live_tiles(bias_row: torch.Tensor, nk: int) -> list:
    """The kernels' live-tile rule for one batch row's (Nk,) key bias."""
    return [t for t in range(-(-nk // TILE))
            if bool((bias_row[TILE * t:TILE * (t + 1)] > 0.5 * tfa.NEG_INF).any())]


def _packed(x_i: torch.Tensor, tiles: list, nk: int):
    """The keys of ``tiles`` in list order, x's rows at them (zeros past
    Nk), and which of them lie inside Nk."""
    keys = torch.tensor([TILE * t + r for t in tiles for r in range(TILE)], dtype=torch.long)
    inside = keys < nk
    rows = torch.zeros(x_i.shape[:-2] + (len(keys), x_i.shape[-1]))
    rows[..., inside, :] = x_i[..., keys[inside], :]
    return keys, inside, rows


def emu_fwd(q, k, v, bias, causal):
    """(out, m, inv) of ``small_fwd_tf32_kernel``."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    scale2 = torch.tensor(1.0 / math.sqrt(dh)) * LOG2E
    neg2 = torch.tensor(tfa.NEG_INF) * LOG2E
    out = torch.zeros(q.shape)
    m = torch.full((b, h, nq), tfa.NEG_INF)
    inv = torch.zeros((b, h, nq))
    rows = torch.arange(nq)[:, None]
    for i in range(b):
        tiles = live_tiles(bias[i], nk)
        if not tiles:   # no live tile: zeros, m = -1e30, inv = 0
            continue
        keys, inside, kp = _packed(k[i], tiles, nk)
        _, _, vp = _packed(v[i], tiles, nk)
        b2 = torch.full((len(keys),), -math.inf)
        b2[inside] = bias[i][keys[inside]] * LOG2E
        s = mm3(q[i], kp.transpose(-1, -2)) * scale2 + b2
        if causal:
            s = torch.where(keys[None, :] > rows, neg2, s)
            s = torch.where(keys[None, :] // TILE > rows // TILE, -math.inf, s)   # tile skipped
        mx = torch.amax(s, dim=-1, keepdim=True)
        met = mx > 0.5 * neg2
        e = torch.where(met, torch.exp2(s - torch.where(met, mx, 0.0)), 0.0)
        inv_i = torch.where(met, 1.0 / e.sum(-1, keepdim=True), 0.0)
        out[i] = mm3(e, vp) * inv_i
        m[i] = torch.where(met, mx * LN2, tfa.NEG_INF)[..., 0]
        inv[i] = inv_i[..., 0]
    return out, m, inv


def emu_bwd(q, k, v, g, m, inv, bias, causal):
    """(dq, dk, dv) of ``small_bwd_tf32_kernel`` from the forward's m, inv."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    dq, dk, dv = torch.zeros(q.shape), torch.zeros(k.shape), torch.zeros(v.shape)
    for i in range(b):
        tiles = live_tiles(bias[i], nk)
        strips = [tiles[j:j + STRIP] for j in range(0, len(tiles), STRIP)]
        for c0 in range(0, nq, CHUNK):
            rows = torch.arange(c0, min(c0 + CHUNK, nq))
            qc, gc = q[i][:, rows], g[i][:, rows]
            mi, ii = m[i][:, rows, None], inv[i][:, rows, None]

            def strip_terms(st):
                keys, inside, kp = _packed(k[i], st, nk)
                _, _, vp = _packed(v[i], st, nk)
                bk = torch.zeros(len(keys))
                bk[inside] = bias[i][keys[inside]]
                s = mm3(qc, kp.transpose(-1, -2)) * scale + bk
                if causal:
                    s = torch.where(keys[None, :] > rows[:, None], tfa.NEG_INF, s)
                e = torch.where(inside, torch.exp(s - mi), 0.0)
                return keys, inside, kp, e, mm3(gc, vp.transpose(-1, -2))

            terms = [strip_terms(st) for st in strips]
            c = sum((dp * e).sum(-1, keepdim=True) for _, _, _, e, dp in terms) * ii
            for n, (keys, inside, kp, e, dp) in enumerate(terms):
                ds = e * ((dp - c) * ii)
                part = mm3(ds, kp) * scale
                dq[i][:, rows] = part if n == 0 else part + dq[i][:, rows]
                kin = keys[inside]
                dk_part = (mm3(ds.transpose(-1, -2), qc) * scale)[:, inside]
                dv_part = mm3(e.transpose(-1, -2), gc * ii)[:, inside]
                dk[i][:, kin] = dk_part if c0 == 0 else dk_part + dk[i][:, kin]
                dv[i][:, kin] = dv_part if c0 == 0 else dv_part + dv[i][:, kin]
    return dq, dk, dv


# (name, Nq, Nk, causal, key mask)
CASES = [("encoder_81x81", 81, 81, False, "ragged"), ("decoder_5x5", 5, 5, True, None),
         ("cross_5x81", 5, 81, False, "ragged"), ("beam_cross_32x81", 32, 81, False, "ragged"),
         ("decode_1x7", 1, 7, False, None), ("dead_middle_tile", 81, 81, False, "holes"),
         ("no_valid_key_rows", 81, 81, False, "dead_rows"),
         ("strips_40x241", 40, 241, False, "long"), ("strips_causal_48x200", 48, 200, True, "long"),
         ("chunks_130x100", 130, 100, False, "long")]


def _operands(name, nq, nk, mask):
    """q, k, v, g (3, 2, N, 64) fp32 and the (3, Nk) key mask (None: every
    key valid), from a seed of the case's name."""
    rng = np.random.RandomState(sum(map(ord, name)))
    q, g = (rng.randn(3, 2, nq, 64).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(3, 2, nk, 64).astype(np.float32) for _ in range(2))
    km = None
    if mask is not None:   # right-padded histories, as the batches hold them
        low = nk - 20 if mask == "long" else 1
        km = np.arange(nk)[None, :] < rng.randint(low, nk + 1, (3,))[:, None]
        if mask == "holes":   # keys 32-47 (tile 2) masked, the rest valid
            km = np.ones((3, nk), bool)
            km[:, 32:48] = False
        if mask == "long":   # a dead tile among more than six live ones
            km[:, 48:64] = False
        if mask == "dead_rows":
            km[:2] = False
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    return t, (None if km is None else torch.from_numpy(km))


def _emulate(name, nq, nk, causal, mask):
    (q, k, v, g), km = _operands(name, nq, nk, mask)
    bias = tfa.mask_bias(km, 3, nk, "cpu")
    out, m, inv = emu_fwd(q, k, v, bias, causal)
    return (q, k, v, g), km, bias, (out, m, inv), emu_bwd(q, k, v, g, m, inv, bias, causal)


def _close(got, want, what):
    for label, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        x, y = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(y))
        assert torch.allclose(x, y, rtol=TOL, atol=TOL), \
            f"{what} {label}: max |err| {float((x - y).abs().max())}"


@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_emulation_matches_the_twins(name, nq, nk, causal, mask):
    (q, k, v, g), km, bias, (out, m, inv), grads = _emulate(name, nq, nk, causal, mask)
    ref, ref_m, ref_inv = tfa._plain_fwd(q, k, v, tfa._key_masker(bias, causal))
    want = tfa._plain_bwd(q, k, v, g, tfa._key_masker(bias, causal))
    _close((out,) + grads, (ref,) + want, name)
    dead = ref_m <= 0.5 * tfa.NEG_INF
    assert bool((m[dead] == tfa.NEG_INF).all()) and bool((inv[dead] == 0).all())
    assert bool((out[dead] == 0).all())
    live = ~dead
    assert float((m - ref_m)[live].abs().max()) <= 1e-5 * float(ref_m[live].abs().max())
    assert float(((inv - ref_inv) / ref_inv)[live].abs().max()) <= 1e-5
    if mask == "dead_rows":   # batch rows 0 and 1 attend nothing: zeros, exactly
        assert bool(dead[:2].all())
        assert max(float(t[:2].abs().max()) for t in (out,) + grads) == 0.0
    if mask == "holes":   # the dead middle tile's keys get no gradient
        assert float(grads[1][:, :, 32:48].abs().max()) == 0.0
        assert float(grads[2][:, :, 32:48].abs().max()) == 0.0
    if mask == "long":   # more live tiles than a strip holds: the strip path runs
        assert max(len(live_tiles(bias[i], nk)) for i in range(3)) > STRIP


@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_emulation_matches_jax_kernel(name, nq, nk, causal, mask):
    (q, k, v, g), km, _, (out, _, _), grads = _emulate(name, nq, nk, causal, mask)
    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    jkm = None if km is None else jnp.asarray(km.numpy())
    jout, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_small(
        a, b_, c, k_mask=jkm, causal=causal, interpret=True), jq, jk, jv)
    _close((out,) + grads, (jout,) + vjp(jg), f"{name} jax")


def _view(dtype, offset=0, dh=64, pad=0):
    """A (2, 3, 5, dh) view of (2, 5, 3, dh + pad) storage, ``offset``
    elements in (the kernels' operand layout)."""
    store = torch.zeros(2 * 5 * 3 * (dh + pad) + offset, dtype=dtype)
    return store[offset:].view(2, 5, 3, dh + pad)[..., :dh].transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_route_restatement(dtype):
    """``small_route`` (the libraries' gates restated; ``chip_smoke.py``
    phase 21 holds it against them on the card) on views of known
    alignment."""
    fam = "tf32x3" if dtype == torch.float32 else "mma_bf16"
    a = _view(dtype)
    assert tfa.small_route(a, a, a, a) == fam
    assert tfa.small_route(a, a, a, a, (a, a, a)) == fam
    assert tfa.small_route(*(_view(dtype, dh=32),) * 4) == "cuda_cores"       # Dh != 64
    odd = _view(dtype, offset=1)                                               # base off 16 bytes
    assert tfa.small_route(a, a, a, odd) == "cuda_cores"
    assert tfa.small_route(a, odd, a, a) == "cuda_cores"
    padded = _view(dtype, pad=2)                                               # rows off 16 bytes
    assert tfa.small_route(a, a, padded, a) == "cuda_cores"
    # the backward's gradients: fp32 needs 16-byte rows, bf16 4-byte pairs
    two = _view(dtype, offset=2)
    assert tfa.small_route(a, a, a, a, (two, a, a)) == (
        "cuda_cores" if dtype == torch.float32 else "mma_bf16")
    assert tfa.small_route(a, a, a, a, (a, a, odd)) == "cuda_cores"
    # the short wrappers count their launches by these routes
    for w in (tfa.flash_attention_small_fwd, tfa.flash_attention_small_bwd):
        assert set(w.route_launches) == set(tfa.SMALL_ROUTES)
