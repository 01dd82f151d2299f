"""The children-window kernel's two epilogues (``Tokens``: the child tokens;
``Mask``: the beam search's validity mask folded in the kernel) against the
JAX package on the CPU.

* the ``Mask`` twin against JAX's Pallas ``children_window`` in interpret
  mode followed by JAX's own one-hot fold, exactly;
* a torch emulation of the CUDA kernel's layout (``csrc/children_window.cu``:
  a warp a row over a grid stride, lane l owning the slots 4 (l + 32 i) + q,
  the 16-byte token stores, the warp's bitmap words and their expansion into
  8-byte rows of 0 / 1) against both twins;
* the wrappers' rejections;
* ``semids.children_mask`` (the ``Mask`` route) against JAX's.

The kernel itself runs only on the GPU (``chip_smoke.py`` holds both
epilogues against these twins on the beam searches' own operands there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops.children_window import children_window as jax_children_window
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu_torch.ops import children_window as cw
from rqvae_tpu_torch.tokenizer import semids as tsem


def _operands(seed, n, r, window, lo_min=0):
    """Random window operands (numpy): distinct sorted keys; rows with an
    empty run, runs that end at the table's end, runs longer than the
    window, and key0 offsets that put children below 0 and at or above the
    token count."""
    rng = np.random.RandomState(seed)
    table = np.sort(rng.choice(2**20, n, replace=False)).astype(np.int64)
    lo = rng.randint(lo_min, n, r).astype(np.int32)
    cnt = rng.randint(0, window + 40, r).astype(np.int32)
    cnt[::7] = 0
    cnt[1::5] = n - lo[1::5]                   # the run ends at the table's end
    cnt = np.minimum(cnt, n - lo).astype(np.int32)
    key0 = table[np.clip(lo, 0, n - 1)] - rng.randint(-5, 40, r)
    return table, lo, cnt, key0.astype(np.int64)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- the Mask twin against Pallas + JAX's fold ----

@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_twin_matches_pallas_and_jax_fold(seed, k):
    n, r = 3 * k + 17, 70
    table, lo, cnt, key0 = _operands(seed, n, r, k)
    # uint32 keys as the JAX index keeps them; the children compare by value
    child = jax_children_window(jnp.asarray(table.astype(np.uint32)), jnp.asarray(lo),
                                jnp.asarray(cnt), jnp.asarray(key0.astype(np.uint32)),
                                window=k, k_tokens=k, block_r=16, interpret=True)
    want = np.asarray(jax.nn.one_hot(child, k + 1).sum(1)[:, :k] > 0)
    args = _torch(table, lo, cnt, key0)
    got = cw.children_window_mask(*args, window=k, k_tokens=k)
    assert got.dtype == torch.bool and tuple(got.shape) == (r, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cw.children_window_mask_plain(*args, window=k, k_tokens=k).numpy(),
                                  want)
    assert want.any(1).sum() > r // 2 and not want[cnt == 0].any()
    # children >= k_tokens occur and are dropped
    tokens = cw.children_window_plain(*args, window=k, k_tokens=k).numpy()
    runs = np.arange(k)[None, :] < np.minimum(cnt, k)[:, None]
    raw = table[np.minimum(lo[:, None] + np.arange(k), n - 1)] - key0[:, None]
    assert ((raw >= k) & runs).any() and ((raw < 0) & runs).any()
    assert (tokens[(raw >= k) & runs] == k).all()


# ---- a torch emulation of the kernel's layout ----

def _spread_bits(byte: int) -> int:
    """csrc/children_window.cu spread_bits, in Python integers."""
    x = byte
    x = (x | (x << 28)) & 0x0000000F0000000F
    x = (x | (x << 14)) & 0x0003000300030003
    x = (x | (x << 7)) & 0x0101010101010101
    return x


def _emulate(table, lo, cnt, key0, window, k_tokens, blocks, warps=8):
    """Both epilogues as the kernel computes them: (tokens (R, W) int32,
    mask (R, K) bool, rows each warp took)."""
    r_rows, n = lo.shape[0], table.shape[0]
    tokens = torch.full((r_rows, window), -1, dtype=torch.int32)
    mask = torch.full((r_rows, k_tokens), 7, dtype=torch.uint8)
    taken = {}
    tok_vec = window % 4 == 0
    mask_vec = k_tokens % 8 == 0
    n_words = (k_tokens + 31) // 32
    for block in range(blocks):
        for warp in range(warps):
            rows = list(range(block * warps + warp, r_rows, blocks * warps))   # the grid stride
            taken[block, warp] = rows
            words = [0xFFFFFFFF] * n_words     # the warp's bitmap, reused row after row
            for r in rows:
                row_lo, row_cnt, row_key0 = int(lo[r]), int(cnt[r]), int(key0[r])  # lanes 0, 1, 2
                end = min(row_cnt, window, n - row_lo)
                jb, je = max(0, -row_lo), max(0, end)

                def token(j):
                    if j < jb or j >= je:
                        return k_tokens
                    child = int(table[row_lo + j]) - row_key0
                    return child if 0 <= child < k_tokens else k_tokens

                # Tokens: lane l stores slots 4 g .. 4 g + 3, g = l + 32 i, at once
                if tok_vec:
                    for lane in range(32):
                        for g in range(lane, window // 4, 32):
                            tokens[r, 4 * g:4 * g + 4] = torch.tensor(
                                [token(4 * g + q) for q in range(4)], dtype=torch.int32)
                else:
                    for lane in range(32):
                        for j in range(lane, window, 32):
                            tokens[r, j] = token(j)
                # Mask: the lanes clear the warp's bitmap words, set them from
                # their slots ...
                for lane in range(32):
                    for w in range(lane, n_words, 32):
                        words[w] = 0
                for lane in range(32):
                    for j0 in range(4 * lane, je, 128):
                        for q in range(4):
                            t = token(j0 + q)
                            if t < k_tokens:
                                words[t >> 5] |= 1 << (t & 31)
                # ... and expanded: lane l writes bytes 8 i .. 8 i + 7, i = l + 32 m
                if mask_vec:
                    for lane in range(32):
                        for i in range(lane, k_tokens // 8, 32):
                            eight = _spread_bits((words[i >> 2] >> (8 * (i & 3))) & 0xFF)
                            mask[r, 8 * i:8 * i + 8] = torch.tensor(
                                list(eight.to_bytes(8, "little")), dtype=torch.uint8)
                else:
                    for lane in range(32):
                        for t in range(lane, k_tokens, 32):
                            mask[r, t] = (words[t >> 5] >> (t & 31)) & 1
    assert (tokens >= 0).all() and (mask <= 1).all(), "a slot or mask byte left unwritten"
    return tokens, mask.bool(), taken


@pytest.mark.parametrize("window,k_tokens,blocks", [
    (256, 256, 2),     # W = K, the serving shape's widths, rows in a grid stride
    (32, 32, 3),       # W = K = 32, a shipped codebook
    (300, 256, 1),     # W > K: slots past K hold children >= K, dropped
    (64, 256, 2),      # W < K
    (33, 37, 2),       # W % 4 != 0 and K % 8 != 0: the scalar stores
    (16, 1024, 1),     # 32 bitmap words a warp: one a lane
    (40, 2048, 1),     # 64 words a warp, two a lane (the stage-1 stretch's codebooks)
])
def test_kernel_layout_emulation_matches_twins(window, k_tokens, blocks):
    n, r = 700, 37
    table, lo, cnt, key0 = _operands(5 + window, n, r, window, lo_min=-3)
    lo[0], cnt[0] = -3, window           # a run that starts before the table
    args = _torch(table, lo, cnt, key0)
    tokens, mask, taken = _emulate(table, lo, cnt, key0, window, k_tokens, blocks)
    want_tokens = cw.children_window_plain(*args, window=window, k_tokens=k_tokens)
    want_mask = cw.children_window_mask_plain(*args, window=window, k_tokens=k_tokens)
    assert torch.equal(tokens, want_tokens)
    assert torch.equal(mask, want_mask)
    assert torch.equal(cw.children_window(*args, window=window, k_tokens=k_tokens), want_tokens)
    assert torch.equal(cw.children_window_mask(*args, window=window, k_tokens=k_tokens), want_mask)
    assert sorted(row for rows in taken.values() for row in rows) == list(range(r))
    assert want_mask.any()


def test_spread_bits_covers_every_byte():
    for byte in range(256):
        got = list(_spread_bits(byte).to_bytes(8, "little"))
        assert got == [(byte >> q) & 1 for q in range(8)]


def test_mask_is_the_fold_of_the_tokens():
    table, lo, cnt, key0 = _operands(9, 900, 200, 256)
    args = _torch(table, lo, cnt, key0)
    tokens = cw.children_window_plain(*args, window=256, k_tokens=256).numpy()
    mask = cw.children_window_mask_plain(*args, window=256, k_tokens=256).numpy()
    for row_tokens, row_mask in zip(tokens, mask):
        np.testing.assert_array_equal(np.flatnonzero(row_mask), np.unique(row_tokens[row_tokens < 256]))


# ---- rejections ----

def _good():
    table, lo, cnt, key0 = _operands(3, 50, 6, 8)
    return _torch(table, lo, cnt, key0)


@pytest.mark.parametrize("wrapper", [cw.children_window, cw.children_window_mask])
@pytest.mark.parametrize("case", ["table_int32", "key0_int32", "lo_int64", "cnt_float",
                                  "table_2d", "rows_differ", "empty_table", "strided", "meta"])
def test_wrappers_reject(wrapper, case):
    table, lo, cnt, key0 = _good()
    if case == "table_int32":
        table = table.int()
    elif case == "key0_int32":
        key0 = key0.int()
    elif case == "lo_int64":
        lo = lo.long()
    elif case == "cnt_float":
        cnt = cnt.float()
    elif case == "table_2d":
        table = table[None]
    elif case == "rows_differ":
        cnt = cnt[:-1]
    elif case == "empty_table":
        table = table[:0]
    elif case == "strided":
        lo = torch.stack([lo, lo], 1)[:, 0]
    elif case == "meta":
        table, lo, cnt, key0 = (t.to("meta") for t in (table, lo, cnt, key0))
    with pytest.raises((TypeError, ValueError)):
        wrapper(table, lo, cnt, key0, window=8, k_tokens=8)


@pytest.mark.parametrize("k_tokens,device", [(0, "cpu"), (0, "cuda"), (cw.MASK_MAX_K + 1, "cuda")])
def test_mask_rejects_k_outside_the_cap(k_tokens, device):
    with pytest.raises(ValueError, match="k_tokens"):
        cw._check_mask_k(k_tokens, torch.device(device))
    if device == "cpu":
        with pytest.raises(ValueError, match="k_tokens"):
            cw.children_window_mask(*_good(), window=8, k_tokens=k_tokens)


def test_mask_takes_the_cap():
    cw._check_mask_k(cw.MASK_MAX_K, torch.device("cuda"))
    # the twin takes any K: past the kernel's cap it is still the fold
    args = _good()
    for k in (cw.MASK_MAX_K, cw.MASK_MAX_K + 1):
        got = cw.children_window_mask(*args, window=8, k_tokens=k)
        assert tuple(got.shape) == (6, k)
        assert torch.equal(got, cw.fold_tokens(cw.children_window_plain(*args, window=8, k_tokens=k), k))


# ---- semids.children_mask: the Mask route, against JAX ----

def _index(cached, k):
    return jsem.build_index(jnp.asarray(cached), codebook_size=k), \
        tsem.build_index(torch.from_numpy(cached), k)


@pytest.mark.parametrize("k", [32, 256])
def test_children_mask_route_matches_jax(k, monkeypatch):
    rng = np.random.RandomState(k)
    ids = rng.randint(0, 6, size=(600, 3)).astype(np.int32)
    dedup = np.asarray(jsem.dedup_column(jnp.asarray(ids), k))
    cached = np.concatenate([ids, dedup[:, None]], axis=1)
    jidx, tidx = _index(cached, k)
    calls = []

    def record(*args, **kwargs):
        calls.append(kwargs)
        return cw.children_window_mask(*args, **kwargs)

    monkeypatch.setattr(tsem, "children_window_mask", record)
    before = cw.children_window_mask.launches
    for length in (0, 1, 2, 3):
        if length == 0:
            prefix = np.zeros((2, 0), np.int32)
        else:
            prefix = np.concatenate([cached[:30, :length],
                                     rng.randint(0, 8, size=(18, length))]).astype(np.int32)
            prefix = prefix.reshape(4, 12, length)
        want = np.asarray(jsem.children_mask(jidx, jnp.asarray(prefix)))
        got = tsem.children_mask(tidx, torch.from_numpy(prefix)).numpy()
        np.testing.assert_array_equal(got, want)
    assert calls == [dict(window=k, k_tokens=k)] * 4       # one Mask call a children_mask
    assert cw.children_window_mask.launches == before      # the twin on the CPU


def test_children_mask_drops_dedup_ranks_beyond_the_codebook():
    cached = np.zeros((40, 4), np.int32)
    cached[:, -1] = np.arange(40)            # 40 duplicates of one 3-tuple
    jidx, tidx = _index(cached, 8)
    prefix = np.zeros((1, 3), np.int32)
    want = np.asarray(jsem.children_mask(jidx, jnp.asarray(prefix)))
    got = tsem.children_mask(tidx, torch.from_numpy(prefix)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.ones(8, bool))
