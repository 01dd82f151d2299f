"""The operation and byte counts behind ``mfu.*`` and ``attn_roofline.*``,
tied to shapes: hand counts at small sizes and PyTorch's own flop counter
over the reference's forward."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference import model as ref_model

S = counts.Shape(embedding_dim=8, attn_dim=16, heads=2, enc_layers=1, dec_layers=1, mlp_dim=32,
                 codebook=10, sem_dim=2)


def test_train_flops_by_hand():
    # one row of 3 items: t = 3 * 2 + 1 = 7 encoder tokens, 3 target-side tokens
    a, f, e, t, n = 16, 32, 8, 7, 3
    enc = t * 2 * (4 * a * a + 2 * a * f) + 4 * a * t * t
    dec = n * 2 * (6 * a * a + 2 * a * f) + 4 * a * a * t + 4 * a * (n * (n + 1) // 2) + 4 * a * n * t
    proj = 2 * e * a * (t + n) + 2 * a * 10 * 2
    assert counts.train_flops(S, [3]) == 3 * (enc + dec + proj)
    # padding costs nothing: only the valid lengths enter
    assert counts.train_flops(S, [3, 5]) == counts.train_flops(S, [3]) + counts.train_flops(S, [5])


def test_forward_against_flop_counter():
    """The reference forward on rows with no padding, counted by PyTorch:
    the model count plus what a dense forward adds (the causal half it
    masks, the logits of the last position)."""
    s = ref_model.DecoderShape(8, 16, 2, 2, 32, 10, 2, 20, 0.0)
    params = ref_model.init_decoder(torch.Generator().manual_seed(0), s, "cpu")
    b, items = 3, 4
    sem = torch.randint(0, 10, (b, items * 2))
    mask = torch.ones_like(sem, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        ref_model.train_loss(params, s, sem, mask, torch.arange(b), torch.randint(0, 10, (b, 2)), None)
    n = 3
    dense_extra = b * (4 * 16 * (n * n - n * (n + 1) // 2) + 2 * 16 * 10)
    assert fc.get_total_flops() == counts.train_flops(S, [items] * b) / 3 + dense_extra


def test_search_flops_by_hand():
    a, f, e, t, k = 16, 32, 8, 5, 4
    enc = t * 2 * (4 * a * a + 2 * a * f) + 4 * a * t * t + 2 * e * a * t + 4 * a * a * t
    steps = 0
    for step in range(2):
        beams = 1 if step == 0 else k
        steps += beams * (2 * (6 * a * a + 2 * a * f) + 4 * a * (step + 1) + 4 * a * t
                          + 2 * e * a + 2 * a * 10)
    assert counts.search_flops(S, [2], k) == enc + steps


def test_attention_bounds():
    call = counts.key_mask_call(np.array([3, 5]), nq=6, heads=2, dh=64)
    assert call == counts.Call(pairs=48, q_rows=12, k_rows=8, heads=2, dh=64)
    fwd_bytes = 4 * 128 * (2 * 12 + 2 * 8)
    assert counts.bound_s(call, "fwd") == pytest.approx(
        max(4 * 64 * 2 * 48 / counts.PEAK_FLOPS["float32"], fwd_bytes / counts.HBM_BYTES_PER_S))
    big = counts.Call(pairs=10**12, q_rows=10, k_rows=10, heads=1, dh=64)
    assert counts.bound_s(big, "bwd") == 8 * 64 * 10**12 / counts.PEAK_FLOPS["float32"]
    assert counts.causal_call(2, 5, 1, 64).pairs == 30


def test_step_calls():
    calls = counts.train_attention_calls(S, [(np.array([3, 1]), 4)])
    assert len(calls) == 3
    assert calls[0].pairs == (2 * 4 + 1) * (7 + 3)         # every query row of the padded bucket
    assert calls[1].pairs == 2 * 6 and calls[2].pairs == 3 * (7 + 3)
    search = counts.search_attention_calls(S, np.array([2]), 3, k=4)
    assert len(search) == 1 + 2 * 2
    assert search[-2].pairs == 4 * 2 and search[-1].pairs == 4 * 5
