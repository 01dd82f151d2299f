"""The decoder-only retriever on DeepSeek-V2's block (``models/rope``,
``models/mla``, ``models/moe``, ``models/retrieval_lm`` and its branch of
``generation.generate_next_sem_ids``) against the benchmark's plain
reference (``portbench/reference/lm.py``), in float32 on seeded random
weights at a small size: hidden 64, 4 heads, latent 32, rope 16 / nope 32 /
v 32, 8 experts of 48 with top-3 and 2 shared, 1 dense + 2 expert layers."""
import math

import numpy as np
import pytest
import torch

from portbench.reference import corpus as ref_corpus
from portbench.reference import lm as ref_lm
from rqvae_tpu_torch.data.schemas import SeqBatch
from rqvae_tpu_torch.models import generation, moe, retrieval_lm, rope
from rqvae_tpu_torch.tokenizer import semids
from rqvae_tpu_torch.utils import profiling

K, LEVELS = 16, 3
D = LEVELS + 1
DEEPSEEK = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
            "intermediate_size": 96, "kv_lora_rank": 32, "moe_intermediate_size": 48,
            "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 8, "n_shared_experts": 2,
            "norm_topk_prob": False, "num_experts_per_tok": 3, "q_lora_rank": None,
            "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "rms_norm_eps": 1e-6,
            "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                             "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                             "type": "yarn"},
            "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
            "topk_group": 1, "topk_method": "greedy", "v_head_dim": 32}
CFG_FILE = dict(DEEPSEEK, decoder={"attn_embed_dim": 64, "attn_heads": 4, "attn_layers": 3,
                                   "vae_codebook_size": K, "vae_n_layers": LEVELS})
SHAPE = ref_lm.lm_shape(CFG_FILE)
CFG = retrieval_lm.config_from_deepseek(DEEPSEEK, num_heads=4, num_embeddings=K, sem_id_dim=D)
MOE_LAYERS = 2


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(11)
    params = ref_lm.init_weights(gen, SHAPE, "cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, K, (300, LEVELS))
    tuples = torch.from_numpy(np.concatenate(
        [codes, ref_corpus.dedup(torch.from_numpy(codes)).numpy()[:, None]], axis=1))
    index = semids.build_index(tuples.to(torch.int32), K)
    lengths = [5, 1, 3, 4]                     # unequal histories, in items
    width = max(lengths)
    ids = np.full((len(lengths), width), -1, np.int32)
    for r, m in enumerate(lengths):
        ids[r, :m] = rng.integers(0, 300, m)
    users = np.array([7, 123456, 2001, 42], np.int32)
    seq = SeqBatch(user_ids=torch.from_numpy(users), ids=torch.from_numpy(ids),
                   ids_fut=torch.zeros((len(lengths), 1), dtype=torch.int32), x=None, x_fut=None,
                   seq_mask=torch.from_numpy(ids >= 0))
    tok = semids.tokenize_sequences(index, seq)._replace(sem_ids_fut=None, token_type_ids_fut=None)
    hists = [ref_lm.history_tokens(tuples, ids[r, :m]) for r, m in enumerate(lengths)]
    return params, tuples, index, tok, hists, users.tolist(), lengths


def test_yarn_table_closed_form():
    """inv_freq, the softmax scale and the cos / sin table against the
    closed form (float64), at DeepSeek-V2-Lite's rotary settings and at the
    small one."""
    for y in (retrieval_lm.RetrievalLMConfig().yarn, CFG.yarn):
        dim, base, f = y.dim, y.theta, y.factor

        def corr(rot):
            return dim * math.log(y.original_max / (rot * 2 * math.pi)) / (2 * math.log(base))

        low, high = max(math.floor(corr(y.beta_fast)), 0), min(math.ceil(corr(y.beta_slow)), dim - 1)
        want = []
        for i in range(dim // 2):
            ramp = min(max((i - low) / (high - low), 0.0), 1.0)
            want.append(base ** (-2 * i / dim) * (1 - ramp) + base ** (-2 * i / dim) / f * ramp)
        got = rope.inv_freq(y)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        assert got[0] == 1.0 and abs(float(got[-1]) - want[-1]) < 1e-12
        cos, sin = rope.table(y, 90)
        ang = np.outer(np.arange(90), want)
        np.testing.assert_allclose(cos[:, :dim // 2].numpy(), np.cos(ang), atol=2e-5)
        np.testing.assert_allclose(sin[:, dim // 2:].numpy(), np.sin(ang), atol=2e-5)
    m = 0.1 * 0.707 * math.log(40) + 1
    from rqvae_tpu_torch.models import mla
    assert abs(mla.softmax_scale(retrieval_lm.RetrievalLMConfig()) - 192 ** -0.5 * m * m) < 1e-12
    assert rope.mscale(40, 0.707) == pytest.approx(m)


def test_rotation_matches_reference():
    x = torch.randn(3, 5, 4, 16)
    pos = torch.arange(5)
    cos, sin = rope.table(CFG.yarn, 5)
    got = rope.apply(x, cos[None, :, None], sin[None, :, None])
    torch.testing.assert_close(got, ref_lm.rotate(x, pos, SHAPE), rtol=1e-5, atol=1e-6)


def test_expert_layer(setup):
    params = setup[0]
    p = params["layers"][1]["moe"]
    x = torch.randn(37, 64, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(moe.experts_layer(p, CFG, x), ref_lm._moe(p, SHAPE, x),
                               rtol=1e-5, atol=1e-5)


def test_prefill_logits(setup):
    params, _, _, tok, hists, users, _ = setup
    logits, hist = retrieval_lm.prefill(params, CFG, tok)
    ref = ref_lm.sequence_logits(params, SHAPE, users, *zip(*hists))
    torch.testing.assert_close(logits, torch.stack([r[-1] for r in ref]), rtol=1e-4, atol=1e-5)
    assert hist.lengths.tolist() == [len(h[0]) + 1 for h in hists]
    assert hist.tokens == sum(len(h[0]) + 1 for h in hists)


def test_decode_through_both_caches(setup):
    """Every level's logits along given beams, the history's latent cache
    shared by the beams, against the reference's whole forward."""
    params, tuples, _, tok, hists, users, _ = setup
    g = torch.Generator().manual_seed(9)
    b, k = len(users), 5
    beams = torch.randint(0, K, (b, k, D), generator=g)
    logits, hist = retrieval_lm.prefill(params, CFG, tok)
    got, own = [logits[:, None].expand(b, k, -1)], None
    for level in range(D - 1):
        logits, own = retrieval_lm.decode_step(params, CFG, hist, own,
                                               beams.reshape(b * k, D)[:, level], level)
        got.append(logits.view(b, k, -1))
    got = torch.stack(got, dim=2)
    pre = ref_corpus.Prefixes(tuples, K)
    _, ref = ref_lm.rescore(params, SHAPE, users, hists, pre, beams)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_search_matches_reference(setup):
    params, tuples, index, tok, hists, users, _ = setup
    k = 8
    out = generation.generate_next_sem_ids(params, CFG, index, tok, k=k, n_candidates=K)
    ref_tuples, ref_scores = ref_lm.beam_search(params, SHAPE, users, hists,
                                                ref_corpus.Prefixes(tuples, K), k)
    torch.testing.assert_close(out.log_probas, ref_scores, rtol=1e-5, atol=1e-4)
    gaps = torch.diff(ref_scores, dim=1).abs()
    apart = torch.ones_like(ref_scores, dtype=torch.bool)
    apart[:, 1:] &= gaps > 1e-3
    apart[:, :-1] &= gaps > 1e-3
    assert int(apart.sum()) >= len(users) * k // 2
    assert torch.equal(out.sem_ids.long()[apart], ref_tuples[apart])


def test_recorded_search_spans_and_counters(setup):
    params, _, index, tok, _, _, lengths = setup
    k = 4
    profiling.enable()
    try:
        generation.generate_next_sem_ids(params, CFG, index, tok, k=k, n_candidates=K)
        rec = profiling.collect()
    finally:
        profiling.disable()
    names = {s[0] for s in rec["spans"]}
    assert {"search", "search.prefill", "search.level", "mla.prefill", "mla.decode", "moe.route",
            "moe.experts", "moe.shared", "mlp.dense"} <= names
    assert names <= set(profiling.VOCABULARY) and set(rec["counters"]) <= set(profiling.COUNTERS)
    tokens = sum(1 + D * m for m in lengths)
    rows = (D - 1) * len(lengths) * k
    assert rec["counters"]["moe.pairs"] == MOE_LAYERS * (tokens + rows) * CFG.top_k
    assert rec["counters"]["mla.cache_tokens"] == SHAPE.layers * sum(
        tokens + len(lengths) * k * (j + 1) for j in range(D - 1))
    assert 0 < rec["counters"]["moe.experts_touched"] <= MOE_LAYERS * D * SHAPE.experts


def test_dispatch_row_ranges():
    """The pairs sorted by expert and each expert's row range, found on the
    device, against a count of the pairs by expert (experts left empty
    included)."""
    idx = torch.randint(0, 8, (29, 3), generator=torch.Generator().manual_seed(2))
    idx[idx == 5] = 6
    order, ends = moe.dispatch(idx, 8)
    flat = idx.flatten()
    assert torch.equal(flat[order], torch.sort(flat, stable=True).values)
    assert torch.equal(ends.long(), torch.cumsum(torch.bincount(flat, minlength=8), 0))
    assert ends.dtype == torch.int32
