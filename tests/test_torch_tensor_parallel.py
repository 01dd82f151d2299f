"""Tensor parallelism in the port (``parallel/mesh.py``, ``parallel/tensor.py``
and the models and loops that use them) on the CPU: gloo processes launched
as subprocesses of this file with ``torchrun``'s variables (a free port, a
timeout of their own), two at mesh (1, 2) and four at (2, 2), both started
at once, against JAX's unsharded functions and the port's one process.

* the spec rules: for every leaf of JAX's ``retrieval.init`` and
  ``rqvae_lib.init`` trees the port's rule names the dimension JAX's
  ``_retrieval_tp_spec`` / ``_rqvae_tp_spec`` names (no mesh needed);
* shard then gather is the identity, bit for bit (``wqkv`` / ``wkv`` carved
  by heads);
* the flat and packed decoder losses and gathered gradients against
  ``jax.grad`` of JAX's unsharded ``retrieval.forward`` / ``forward_packed``
  on the same parameters (``models/convert``) at dropout 0, ``rtol=2e-5,
  atol=1e-6``; stage 1 in STE (with SimVQ and a normalised level 0),
  rotation trick and Gumbel-softmax (JAX's uniforms injected) against
  ``rqvae_lib.forward``, ``rtol=2e-5, atol=1e-5`` (JAX's own tolerances in
  ``tests/test_sharding.py``), with no ``rq_quantize_train`` call;
* equal codewords on two shards: the lowest global index wins;
* dropout 0.3 at (1, 2) equals one process with the same seed (loss
  ``rtol=1e-5``); the Adam moments take the shards' shapes; the beam search
  at (1, 2) equals one process;
* the collectives of one flat training step (forward and backward), by the
  formula of ``_flat_step_collectives``;
* ``train()`` of both stages with ``tensor_parallel=True``: at (1, 2) the
  logs equal one process's and the checkpoint (the whole layout) restores
  into one process with its leaves; at (2, 2) the logs equal the port's
  (2, 1) data-parallel run (the same data blocks); a one-process checkpoint
  restores into the (1, 2) shards; ``run_eval`` at (2, 2) equals one
  process with exhaustive candidates to 1e-6;
* heads that do not divide over the model axis: the four ranks then run a
  6-head decoder at mesh (1, 4), whose attention leaves stay whole on every
  rank (every other leaf on JAX's dimension): shard and gather round-trip
  bit for bit, flat and packed gradients against JAX's unsharded ones at
  ``rtol=2e-5, atol=1e-6``, the beam search equal to one process, the
  collectives of a flat step by the formula with no attention collective,
  ``train()`` equal to one process (``rtol=1e-5``) with a whole checkpoint
  that restores into one process, and ``run_eval`` equal to one process; an
  uneven leaf dimension still raises ``ValueError``, as JAX's
  ``device_put`` does.

Run alone: ``python -m pytest tests/test_torch_tensor_parallel.py -q``.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:   # run as a worker: python tests/test_torch_tensor_parallel.py
    sys.path.insert(0, str(REPO))

from rqvae_tpu_torch.data import packing as tpacking  # noqa: E402
from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch as TBatch  # noqa: E402
from rqvae_tpu_torch.evaluate import run_eval  # noqa: E402
from rqvae_tpu_torch.models import generation as tgen  # noqa: E402
from rqvae_tpu_torch.models import io as model_io  # noqa: E402
from rqvae_tpu_torch.models import quantize as tq  # noqa: E402
from rqvae_tpu_torch.models import retrieval as tret  # noqa: E402
from rqvae_tpu_torch.models import rqvae as trq  # noqa: E402
from rqvae_tpu_torch.ops import dispatch  # noqa: E402
from rqvae_tpu_torch.parallel import mesh  # noqa: E402
from rqvae_tpu_torch.parallel import tensor as ttp  # noqa: E402
from rqvae_tpu_torch.tokenizer import semids as tsem  # noqa: E402
from rqvae_tpu_torch.train import checkpoint, optim  # noqa: E402
from rqvae_tpu_torch.train import train_decoder as ttd  # noqa: E402
from rqvae_tpu_torch.train import train_rqvae as ttr  # noqa: E402
from rqvae_tpu_torch.utils import config as tconfig  # noqa: E402
from rqvae_tpu_torch.utils.logging import MetricsLogger  # noqa: E402
from rqvae_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_shapes  # noqa: E402

K = 16
D = 4
N_ITEMS = 40
CAP = 16                  # items a packed row holds
CFG_FIELDS = dict(embedding_dim=16, attn_dim=32, dropout=0.0, num_heads=4, n_layers=4,
                  num_embeddings=K, sem_id_dim=D, max_pos=CAP * D, input_dropout=0.0,
                  mlp_hidden_dim=64)
TCFG = tret.RetrievalConfig(**CFG_FIELDS)
H6_FIELDS = dict(CFG_FIELDS, attn_dim=48, num_heads=6)   # 6 heads of 8: whole on 4 ranks
H6CFG = tret.RetrievalConfig(**H6_FIELDS)
H6_MESH = (1, 4)
RQ_FIELDS = dict(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=16, n_layers=3,
                 n_cat_feats=0)
RQ_MODES = {"STE": dict(codebook_sim_vq=True, codebook_normalize=True),
            "ROTATION_TRICK": {}, "GUMBEL_SOFTMAX": {}}
GLOBAL_ROWS = 8
RQ_ROWS = 32
GUMBEL_T = 0.2
WORLDS = {2: (1, 2), 4: (2, 2)}


class _Capture(MetricsLogger):
    def __init__(self):
        super().__init__(every=1)
        self.records = []

    def log(self, step, metrics, force=False):
        self.records.append({"step": step, **{k: float(np.asarray(v)) for k, v in metrics.items()}})


def _rq_cfg(mode):
    return trq.RqVaeConfig(codebook_mode=mode, **RQ_FIELDS, **RQ_MODES[mode])


def _flat_step_collectives(enc_layers: int, dec_layers: int, heads_split: bool = True) -> dict:
    """The collectives of one flat forward and backward on a model axis
    above 1. Forward: the two vocab-parallel lookups (history, future) and
    the row-parallel outputs (2 an encoder layer: attention and FFN; 3 a
    decoder layer: self, cross, FFN; 1 for ``out_proj``) all-reduce; the two
    gathered input projections all-gather. Backward: each copied input of a
    column-parallel projection all-reduces (2 an encoder layer, 3 a decoder
    layer: self, cross query, FFN; the decoder's context once; the two input
    projections), and ``out_proj``'s scattered input all-gathers. With whole
    heads (``heads_split`` false) attention issues none: only the FFN's
    remain of the layers' collectives."""
    if not heads_split:
        fwd = 2 + enc_layers + dec_layers + 1
        bwd = enc_layers + dec_layers + 2
    else:
        fwd = 2 + 2 * enc_layers + 3 * dec_layers + 1
        bwd = 2 * enc_layers + 3 * dec_layers + 1 + 2
    return {"all_reduce": fwd + bwd, "all_gather": 2 + 1}


# ---- inputs, made in the test process and read by every worker ----

def _flat_batch(rows=GLOBAL_ROWS, n_items=5, seed=1):
    rng = np.random.RandomState(seed)
    n = n_items * D
    arrays = dict(
        user_ids=np.arange(rows, dtype=np.int32) * 977 - 3,
        sem_ids=rng.randint(0, K, size=(rows, n)).astype(np.int32),
        seq_mask=np.ones((rows, n), dtype=bool),
        token_type_ids=np.tile(np.arange(D, dtype=np.int32), (rows, n_items)),
        sem_ids_fut=rng.randint(0, K, size=(rows, D)).astype(np.int32),
        token_type_ids_fut=np.tile(np.arange(D, dtype=np.int32), (rows, 1)),
    )
    arrays["seq_mask"][0, -D:] = False
    arrays["sem_ids"][0, -D:] = -1
    arrays["seq_mask"][3, -2 * D:] = False
    arrays["sem_ids"][3, -2 * D:] = -1
    return arrays


def _index():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, K, (N_ITEMS, 3)).astype(np.int32)
    cached = np.concatenate([ids, np.zeros((N_ITEMS, 1), np.int32)], axis=1)
    cached[:, -1] = tsem.dedup_column(torch.from_numpy(ids), K).numpy()
    return cached


def _packed_tok(cached):
    """Two replicas' packed batches of 2 rows x 4 slots, tokenized; the
    global batch is their rows in order."""
    rng = np.random.RandomState(4)
    index = tsem.build_index(torch.from_numpy(cached), K)
    toks = []
    for _ in range(2):
        crops = [(int(rng.randint(0, 500)), rng.randint(0, N_ITEMS, rng.randint(2, 7))
                  .astype(np.int32), int(rng.randint(0, N_ITEMS))) for _ in range(7)]
        batch, left = tpacking.pack_crops(crops, rows=2, slots=4, capacity=CAP)
        assert not left
        toks.append(tsem.tokenize_packed(index, tpacking.to_device(batch, "cpu")))
    return toks


def _rows(tree, sl):
    return type(tree)(*(t[sl] if isinstance(t, torch.Tensor) else t for t in tree))


def _cat(toks):
    return type(toks[0])(*(torch.cat(ts) for ts in zip(*toks)))


# ---- the workers ----

def _grads(loss_fn, params):
    loss, _, grads = ttd.value_and_grad(lambda p: (loss_fn(p), torch.zeros(())), params)
    return loss, grads


def _worker_steps(inp, shape, out):
    d, m = shape
    mesh.make_mesh(shape, tensor_parallel=True)
    di = mesh.data_index()
    res = {"data_index": di, "model_index": ttp.index(), "tp": ttp.size()}
    params = inp["params"]
    spec = mesh.retrieval_tp_spec
    sharded = mesh.shard_params(params, spec, TCFG.num_heads)
    res["roundtrip"] = mesh.gather_params(sharded, spec, TCFG.num_heads)
    rq_sharded = mesh.shard_params(inp["rq_params"]["STE"], mesh.rqvae_tp_spec)
    res["rq_roundtrip"] = mesh.gather_params(rq_sharded, mesh.rqvae_tp_spec)
    model_io.save_pretrained(str(out / "export"), rq_sharded, _rq_cfg("STE"))   # whole
    res["local_shapes"] = tree_shapes(sharded)

    # flat: the data replica's rows, gradients meaned over the data group
    rows = slice(di * GLOBAL_ROWS // d, (di + 1) * GLOBAL_ROWS // d)
    tok = _rows(inp["flat"], rows)
    ttp.calls.clear()
    mesh.collective_calls = 0
    loss, grads = _grads(lambda p: tret.forward(p, TCFG, tok).loss, sharded)
    res["flat_calls"] = dict(ttp.calls)
    mesh.all_reduce_(tree_leaves(grads), "mean")
    res["flat_data_calls"] = mesh.collective_calls
    res["flat"] = (float(mesh.all_reduce_([loss.clone()], "mean")[0]),
                   mesh.gather_params(grads, spec, TCFG.num_heads))

    # packed: the replica's packed rows (all of them on one data replica),
    # the loss over the global valid slots, gradients summed
    ptoks = inp["packed"]
    ptok = ptoks[di] if d == 2 else _cat(ptoks)
    n_valid = mesh.all_reduce_sum(torch.sum(ptok.slot_valid))
    loss, grads = _grads(lambda p: tret.forward_packed(p, TCFG, ptok, n_valid=n_valid).loss,
                         sharded)
    mesh.all_reduce_(tree_leaves(grads), "sum")
    res["packed"] = (float(mesh.all_reduce_([loss.clone()], "sum")[0]),
                     mesh.gather_params(grads, spec, TCFG.num_heads))

    # stage 1 in each mode; the Gumbel estimator reads JAX's uniforms
    fused = []
    real_fused = trq._fused_train_quantize
    trq._fused_train_quantize = lambda *a: fused.append(1) or real_fused(*a)
    real_sample = tq.gumbel_softmax_sample
    xrows = slice(di * RQ_ROWS // d, (di + 1) * RQ_ROWS // d)
    res["stage1"] = {}
    for mode in RQ_MODES:
        feed = iter([u[xrows] for u in inp["uniforms"]])
        tq.gumbel_softmax_sample = lambda logits, t, **kw: real_sample(logits, t,
                                                                       uniform=next(feed))
        cfg = _rq_cfg(mode)
        p = mesh.shard_params(inp["rq_params"][mode], mesh.rqvae_tp_spec)
        loss, grads = _grads(lambda q: trq.forward(q, cfg, inp["rq_x"][xrows], gumbel_t=GUMBEL_T,
                                                   training=True).loss, p)
        mesh.all_reduce_(tree_leaves(grads), "mean")
        res["stage1"][mode] = (float(mesh.all_reduce_([loss.clone()], "mean")[0]),
                               mesh.gather_params(grads, mesh.rqvae_tp_spec))
    tq.gumbel_softmax_sample = real_sample
    trq._fused_train_quantize = real_fused
    res["fused_calls"] = len(fused)

    # equal codewords on both shards: rows 3 and 11 of 16 (and 12 on shard 1)
    cb = torch.from_numpy(np.random.RandomState(7).randn(K, 8).astype(np.float32))
    cb[11] = cb[3]
    cb[12] = cb[3]
    x = cb[3][None].repeat(4, 1) + 1e-3 * torch.from_numpy(
        np.random.RandomState(8).randn(4, 8).astype(np.float32))
    x[1] = cb[3]
    local = {"codebook": mesh.shard_params({"layers": [{"codebook": cb}]}, mesh.rqvae_tp_spec)
             ["layers"][0]["codebook"]}
    res["tie_ids"] = tq.apply(local, x).ids

    # the Adam moments take the shards' shapes; count stays replicated
    opt = optim.adamw(1e-3)
    st = mesh.shard_state({"params": params, "opt_state": opt.init(params)}, spec,
                          TCFG.num_heads)
    res["moment_shapes"] = (tree_shapes(st["opt_state"].mu), tree_shapes(st["opt_state"].nu),
                            st["opt_state"].count, tree_shapes(opt.init(sharded).mu))

    if d == 1:
        # dropout 0.3 from a generator seeded alike on both ranks
        cfg = tret.RetrievalConfig(**{**CFG_FIELDS, "dropout": 0.3, "input_dropout": 0.3})
        gen = torch.Generator().manual_seed(11)
        res["dropout_loss"] = float(tret.forward(sharded, cfg, inp["flat"], training=True,
                                                 generator=gen).loss)
        # the beam search on the shards
        index = tsem.build_index(torch.from_numpy(inp["cached"]), K)
        beam = tgen.generate_next_sem_ids(sharded, TCFG, index, inp["flat"]._replace(
            sem_ids_fut=None, token_type_ids_fut=None), k=4, n_candidates=K)
        res["beam"] = (beam.sem_ids, beam.log_probas)
    return res


def _stage1_cfg(root, name, **kw):
    return tconfig.from_dict(ttr.RqVaeTrainConfig, dict(
        iterations=8, batch_size=16, learning_rate=1e-3, dataset="SYNTHETIC", vae_input_dim=16,
        vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=16, vae_n_cat_feats=0,
        vae_n_layers=3, vae_codebook_mode="ROTATION_TRICK", eval_every=8, save_model_every=8,
        save_dir_root=str(root / name), log_every=4, synthetic_n_items=300,
        kmeans_prime_items=200, eval_batches=2, seed=0, steps_per_call=4, **kw))


def _decoder_cfg(root, name, **kw):
    return tconfig.from_dict(ttd.DecoderTrainConfig, dict(dict(
        dataset="SYNTHETIC", vae_input_dim=16, vae_hidden_dims=(16,), vae_embed_dim=8,
        vae_codebook_size=16, vae_n_cat_feats=0, vae_n_layers=3,
        vae_codebook_mode="ROTATION_TRICK", synthetic_n_items=300, seed=0, iterations=6,
        batch_size=8, learning_rate=1e-3, pretrained_rqvae_path=str(root / "rq_one"),
        save_dir_root=str(root / name), synthetic_n_users=120, attn_embed_dim=32,
        attn_heads=4, attn_layers=4, decoder_embed_dim=16, dropout_p=0.1, log_every=3,
        partial_eval_every=6, full_eval_every=6, eval_batches=2, warmup_steps=10,
        generation_top_k=4, generation_candidates=16, amp=False), **kw))


H6_TRAIN = dict(attn_embed_dim=48, attn_heads=6)   # the 6-head decoder's train() fields


def _worker_train(root, shape):
    logs = {}
    runs = [("rq", ttr.train, _stage1_cfg), ("dec", ttd.train, _decoder_cfg)]
    tag = f"{shape[0]}x{shape[1]}"
    for name, fn, make in runs:
        cap = _Capture()
        fn(make(root, f"{name}_tp{tag}", mesh_shape=shape, tensor_parallel=True), logger=cap,
           device="cpu")
        logs[f"{name}_tp"] = cap.records
    if shape == (1, 2):
        for name, fn, make in runs:   # the data-parallel run the (2, 2) one is held to
            cap = _Capture()
            fn(make(root, f"{name}_dp", mesh_shape=(2, 1)), logger=cap, device="cpu")
            logs[f"{name}_dp"] = cap.records
        # a one-process checkpoint restored into the shards
        mesh.make_mesh(shape, tensor_parallel=True)
        state, _ = checkpoint.restore(str(root / "rq_one"), device="cpu")
        sharded = mesh.shard_state(state, mesh.rqvae_tp_spec)
        x = torch.from_numpy(np.random.RandomState(2).randn(16, 16).astype(np.float32))
        cfg = _stage1_cfg(root, "rq_one").model_config()
        logs["restored_eval_loss"] = float(trq.forward(sharded["params"], cfg, x,
                                                       gumbel_t=0.2).loss)
        logs["restored_shapes"] = tree_shapes(sharded["opt_state"].mu)
    ev = None
    if shape == (2, 2):   # the parameters stay whole on a model axis
        ev = run_eval.evaluate_checkpoint(_decoder_cfg(root, f"dec_tp{tag}", mesh_shape=shape,
                                                       tensor_parallel=True),
                                          split="eval", device="cpu")
    return {"logs": logs, "eval": ev}


def _worker_whole_heads(inp, root):
    """The 6-head decoder at mesh (1, 4): its heads do not divide over the
    model axis, so the attention leaves stay whole on every rank."""
    mesh.make_mesh(H6_MESH, tensor_parallel=True)
    params = inp["params6"]
    spec = mesh.retrieval_tp_spec
    res = {"tp": ttp.size(), "split": ttp.heads_split(H6CFG.num_heads),
           "local_heads": ttp.local_heads(H6CFG.num_heads)}
    sharded = mesh.shard_params(params, spec, H6CFG.num_heads)
    res["local_shapes"] = tree_shapes(sharded)
    res["roundtrip"] = mesh.gather_params(sharded, spec, H6CFG.num_heads)
    st = mesh.shard_state({"params": params, "opt_state": optim.adamw(1e-3).init(params)}, spec,
                          H6CFG.num_heads)
    res["moment_shapes"] = tree_shapes(st["opt_state"].mu)

    ttp.calls.clear()
    loss, grads = _grads(lambda p: tret.forward(p, H6CFG, inp["flat"]).loss, sharded)
    res["flat_calls"] = dict(ttp.calls)
    res["flat"] = (float(loss), mesh.gather_params(grads, spec, H6CFG.num_heads))
    ptok = _cat(inp["packed"])
    loss, grads = _grads(lambda p: tret.forward_packed(p, H6CFG, ptok).loss, sharded)
    res["packed"] = (float(loss), mesh.gather_params(grads, spec, H6CFG.num_heads))

    index = tsem.build_index(torch.from_numpy(inp["cached"]), K)
    beam = tgen.generate_next_sem_ids(sharded, H6CFG, index, inp["flat"]._replace(
        sem_ids_fut=None, token_type_ids_fut=None), k=4, n_candidates=K)
    res["beam"] = (beam.sem_ids, beam.log_probas)

    # an uneven leaf still raises, and the retrieval layout needs the heads
    res["raises"] = []
    for fn in (lambda: mesh.shard_params({"layers": [{"codebook": torch.zeros(18, 8)}]},
                                         mesh.rqvae_tp_spec),
               lambda: mesh.shard_params(params, spec)):
        try:
            fn()
            res["raises"].append(None)
        except ValueError as e:
            res["raises"].append(str(e))

    cap = _Capture()
    ttd.train(_decoder_cfg(root, "dec_h6_tp", mesh_shape=H6_MESH, tensor_parallel=True,
                           **H6_TRAIN), logger=cap, device="cpu")
    res["train"] = cap.records
    res["eval"] = run_eval.evaluate_checkpoint(
        _decoder_cfg(root, "dec_h6_tp", mesh_shape=H6_MESH, tensor_parallel=True, **H6_TRAIN),
        split="eval", device="cpu")
    return res


def _worker(kind_dir: pathlib.Path):
    torch.set_num_threads(1)
    world = mesh.maybe_init_distributed("cpu")
    shape = WORLDS[world]
    inp = torch.load(kind_dir / "inputs.pt", weights_only=False)
    res = {"steps": _worker_steps(inp, shape, kind_dir),
           "train": _worker_train(kind_dir.parent, shape)}
    if world == 4:
        res["whole_heads"] = _worker_whole_heads(inp, kind_dir.parent)
    torch.save(res, kind_dir / f"r{mesh.rank()}.pt")


# ---- the launcher ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(world: int, out_dir: pathlib.Path):
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("RQVAE_TPU_DISABLE_PALLAS", None)
        procs.append(subprocess.Popen([sys.executable, __file__, str(out_dir)], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def _wait(procs, out_dir: pathlib.Path, timeout: int = 300):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"workers did not finish in {timeout} s (mismatched collectives?)")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {len(procs)} failed:\n{out[-4000:]}"
    return [torch.load(out_dir / f"r{r}.pt", weights_only=False) for r in range(len(procs))]


def _jax_inputs():
    import jax

    from rqvae_tpu.models import retrieval as jret
    from rqvae_tpu.models import rqvae as jrq
    from rqvae_tpu_torch.models import convert

    jcfg = jret.RetrievalConfig(**CFG_FIELDS)
    jp = jax.device_get(jax.jit(lambda key: jret.init(key, jcfg))(jax.random.PRNGKey(0)))
    jcfg6 = jret.RetrievalConfig(**H6_FIELDS)
    jp6 = jax.device_get(jax.jit(lambda key: jret.init(key, jcfg6))(jax.random.PRNGKey(6)))
    rq = {}
    for mode in RQ_MODES:
        jrc = jrq.RqVaeConfig(codebook_mode=jrq.QuantizeForwardMode[mode], **RQ_FIELDS,
                              **RQ_MODES[mode])
        rq[mode] = jax.device_get(jrq.init(jax.random.PRNGKey(1), jrc))
    cached = _index()
    flat = TBatch(**{k: torch.from_numpy(v) for k, v in _flat_batch().items()})
    key = jax.random.PRNGKey(3)
    uniforms = []
    for _ in range(RQ_FIELDS["n_layers"]):   # the draws of JAX's get_semantic_ids
        key, sub = jax.random.split(key)
        uniforms.append(np.asarray(jax.random.uniform(sub, (RQ_ROWS, K), dtype=np.float32)))
    inputs = {
        "params": convert.from_numpy(jp, device="cpu"),
        "params6": convert.from_numpy(jp6, device="cpu"),
        "rq_params": {m: convert.from_numpy(p, device="cpu") for m, p in rq.items()},
        "flat": flat, "packed": _packed_tok(cached), "cached": cached,
        "rq_x": torch.from_numpy(np.random.RandomState(5).randn(RQ_ROWS, 16).astype(np.float32)),
        "uniforms": [torch.from_numpy(u.copy()) for u in uniforms],
    }
    return inputs, {"4": jp, "6": jp6}, rq, key


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    inputs, jp, jrq_params, _ = _jax_inputs()
    # the stage-1 checkpoint every decoder run reads, trained on one process
    saved = dispatch.execution_mesh()
    dispatch.set_execution_mesh(None)
    try:
        one = {"rq_one": _Capture()}
        ttr.train(_stage1_cfg(root, "rq_one"), logger=one["rq_one"], device="cpu")
        dirs = {}
        for world in WORLDS:
            dirs[world] = root / f"w{world}"
            dirs[world].mkdir()
            torch.save(inputs, dirs[world] / "inputs.pt")
        procs = {world: _start(world, dirs[world]) for world in WORLDS}
        # meanwhile: the one-process references
        one["dec_one"] = _Capture()
        ttd.train(_decoder_cfg(root, "dec_one"), logger=one["dec_one"], device="cpu")
        one["dec_h6_one"] = _Capture()
        ttd.train(_decoder_cfg(root, "dec_h6_one", **H6_TRAIN), logger=one["dec_h6_one"],
                  device="cpu")
        ranks = {world: _wait(procs[world], dirs[world]) for world in WORLDS}
        # the (2, 2) and the 6-head (1, 4) runs' checkpoints scored by one process
        one_eval = run_eval.evaluate_checkpoint(_decoder_cfg(root, "dec_tp2x2"), split="eval",
                                                device="cpu")
        one_eval_h6 = run_eval.evaluate_checkpoint(_decoder_cfg(root, "dec_h6_tp", **H6_TRAIN),
                                                   split="eval", device="cpu")
    finally:
        dispatch.set_execution_mesh(saved)
    return dict(root=root, inputs=inputs, jp=jp["4"], jp6=jp["6"], jrq=jrq_params, one=one,
                one_eval=one_eval, one_eval_h6=one_eval_h6, ranks=ranks)


def _assert_tree_close(got, want, rtol, atol):
    got = list(tree_leaves_with_path(got))
    want = [(p, np.asarray(x)) for p, x in tree_leaves_with_path(want)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=rtol, atol=atol, err_msg=str(path))


# ---- the tests ----

def test_spec_rules_name_jax_dimensions():
    import jax
    from jax.sharding import PartitionSpec as P

    from rqvae_tpu.models import retrieval as jret
    from rqvae_tpu.models import rqvae as jrq
    from rqvae_tpu.parallel import mesh as jmesh

    jcfg = jret.RetrievalConfig(**CFG_FIELDS)
    trees = [(jax.eval_shape(lambda: jret.init(jax.random.PRNGKey(0), jcfg)),
              jmesh._retrieval_tp_spec, mesh.retrieval_tp_spec)]
    for mode in RQ_MODES:
        jrc = jrq.RqVaeConfig(codebook_mode=jrq.QuantizeForwardMode[mode], **RQ_FIELDS,
                              **RQ_MODES[mode])
        trees.append((jax.eval_shape(lambda c=jrc: jrq.init(jax.random.PRNGKey(0), c)),
                      jmesh._rqvae_tp_spec, mesh.rqvae_tp_spec))
    split = 0
    for tree, jrule, trule in trees:
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            path = jmesh._path_str(kp)
            want = jrule(path, leaf)
            port_path = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp)
            assert mesh.path_str(port_path) == path
            assert P(*trule(path, leaf)) == want, path
            split += bool(want)
    assert split >= 30
    # the layout test_tp_specs_cover_every_big_matrix pins, the cross-attention wq included
    blk = {"wq": (None, "model"), "wkv": (None, "model"), "proj": ("model", None)}
    for name, spec in blk.items():
        assert mesh.retrieval_tp_spec(f"transformer/decoder[0]/cross_attn/{name}",
                                      torch.zeros(2, 2)) == spec


def test_shard_and_gather_round_trip_bit_exact(runs):
    inputs = runs["inputs"]
    for world in WORLDS:   # save_pretrained of the shards writes the whole tree
        params, cfg = model_io.load_pretrained(str(runs["root"] / f"w{world}" / "export"),
                                               device="cpu")
        assert cfg == _rq_cfg("STE")
        for (p, a), (_, b) in zip(tree_leaves_with_path(params),
                                  tree_leaves_with_path(inputs["rq_params"]["STE"])):
            assert torch.equal(a, b), p
    for world, ranks in runs["ranks"].items():
        for res in ranks:
            for got, want in ((res["steps"]["roundtrip"], inputs["params"]),
                              (res["steps"]["rq_roundtrip"], inputs["rq_params"]["STE"])):
                for (p, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
                    assert torch.equal(a, b), p
    # rank 1 of (1, 2) holds heads 2-3 of q, k and v in wqkv
    res = runs["ranks"][2][1]["steps"]
    assert res["model_index"] == 1 and res["tp"] == 2
    shapes = dict(res["local_shapes"])
    assert shapes[("transformer", "encoder", 0, "attn", "wqkv")] == (32, 48)
    assert shapes[("sem_emb",)] == (inputs["params"]["sem_emb"].shape[0] // 2, 16)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("path", ["flat", "packed"])
def test_decoder_gradients_match_jax_unsharded(runs, world, path):
    import jax
    import jax.numpy as jnp

    from rqvae_tpu.models import retrieval as jret
    from rqvae_tpu.tokenizer import semids as jsem

    jcfg = jret.RetrievalConfig(**CFG_FIELDS)
    if path == "flat":
        from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch

        jtok = JBatch(**{k: jnp.asarray(v) for k, v in _flat_batch().items()})
        fn = lambda p: jret.forward(p, jcfg, jtok).loss  # noqa: E731
    else:
        tok = _cat(runs["inputs"]["packed"])
        jtok = jsem.PackedTokenizedBatch(*(jnp.asarray(t.numpy()) for t in tok))
        fn = lambda p: jret.forward_packed(p, jcfg, jtok).loss  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(fn))(jax.tree.map(jnp.asarray, runs["jp"]))
    for res in runs["ranks"][world]:
        tloss, tgrads = res["steps"][path]
        np.testing.assert_allclose(tloss, float(loss), rtol=2e-5)
        _assert_tree_close(tgrads, jax.device_get(grads), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("mode", sorted(RQ_MODES))
def test_stage1_gradients_match_jax_unsharded(runs, world, mode):
    import jax
    import jax.numpy as jnp

    from rqvae_tpu.models import rqvae as jrq

    jrc = jrq.RqVaeConfig(codebook_mode=jrq.QuantizeForwardMode[mode], **RQ_FIELDS,
                          **RQ_MODES[mode])
    x = jnp.asarray(runs["inputs"]["rq_x"].numpy())
    fn = lambda p: jrq.forward(p, jrc, x, gumbel_t=GUMBEL_T, training=True,  # noqa: E731
                               rng=jax.random.PRNGKey(3)).loss
    loss, grads = jax.jit(jax.value_and_grad(fn))(jax.tree.map(jnp.asarray, runs["jrq"][mode]))
    for res in runs["ranks"][world]:
        tloss, tgrads = res["steps"]["stage1"][mode]
        np.testing.assert_allclose(tloss, float(loss), rtol=2e-5)
        _assert_tree_close(tgrads, jax.device_get(grads), rtol=2e-5, atol=1e-5)
        assert res["steps"]["fused_calls"] == 0     # JAX's gate: no fused kernel under TP


def test_cross_shard_ties_pick_the_lowest_index(runs):
    for ranks in runs["ranks"].values():
        for res in ranks:
            ids = res["steps"]["tie_ids"]
            assert ids.dtype == torch.int32 and ids.tolist() == [3, 3, 3, 3]


def test_dropout_matches_one_process_with_the_same_seed(runs):
    cfg = tret.RetrievalConfig(**{**CFG_FIELDS, "dropout": 0.3, "input_dropout": 0.3})
    inputs = runs["inputs"]
    want = float(tret.forward(inputs["params"], cfg, inputs["flat"], training=True,
                              generator=torch.Generator().manual_seed(11)).loss)
    nodrop = float(tret.forward(inputs["params"], TCFG, inputs["flat"]).loss)
    for res in runs["ranks"][2]:
        np.testing.assert_allclose(res["steps"]["dropout_loss"], want, rtol=1e-5)
    assert abs(want - nodrop) > 1e-3    # the masks did change the loss


def test_moments_take_the_shards_shapes(runs):
    for ranks in runs["ranks"].values():
        for res in ranks:
            mu, nu, count, fresh = res["steps"]["moment_shapes"]
            assert mu == nu == fresh == res["steps"]["local_shapes"] and count == 0


def test_beam_search_matches_one_process(runs):
    inputs = runs["inputs"]
    index = tsem.build_index(torch.from_numpy(inputs["cached"]), K)
    want = tgen.generate_next_sem_ids(inputs["params"], TCFG, index, inputs["flat"]._replace(
        sem_ids_fut=None, token_type_ids_fut=None), k=4, n_candidates=K)
    lp = want.log_probas.numpy()
    apart = np.all(np.abs(np.diff(lp, axis=1)) > 1e-4, axis=1)
    assert apart.sum() >= GLOBAL_ROWS // 2
    for res in runs["ranks"][2]:
        ids, logp = res["steps"]["beam"]
        np.testing.assert_array_equal(ids.numpy()[apart], want.sem_ids.numpy()[apart])
        np.testing.assert_allclose(logp.numpy(), lp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_flat_step_collectives_follow_the_formula(runs, world):
    want = _flat_step_collectives(TCFG.n_layers // 2, TCFG.n_layers // 2)
    for res in runs["ranks"][world]:
        assert res["steps"]["flat_calls"] == want
        # the gradients: one flat all-reduce over the data group when it has two replicas
        assert res["steps"]["flat_data_calls"] == (1 if world == 4 else 0)


def _common_losses(records_a, records_b):
    """The losses both runs logged, by (name, step): the train and eval
    losses and their parts (other metrics, e.g. the residuals' norms, sit
    on cancellations that fp32 sums in another order move further)."""
    keyed = [{(k, r["step"]): v for r in recs for k, v in r.items() if "loss" in k}
             for recs in (records_a, records_b)]
    return {k: (keyed[0][k], keyed[1][k]) for k in set(keyed[0]) & set(keyed[1])}


@pytest.mark.parametrize("stage", ["rq", "dec"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_train_loop_tensor_parallel_equals_reference(runs, stage, world):
    """(1, 2) against one process; (2, 2) against the (2, 1) data-parallel
    run, whose replicas read the same blocks."""
    ranks = runs["ranks"][world]
    want = (runs["one"][f"{stage}_one"].records if world == 2
            else runs["ranks"][2][0]["train"]["logs"][f"{stage}_dp"])
    for res in ranks:
        got = res["train"]["logs"][f"{stage}_tp"]
        common = _common_losses(got, want)
        assert len(common) >= (8 if stage == "rq" else 10)
        for key, (a, b) in common.items():
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=str(key))
    losses = [r["total_loss"] for r in ranks[0]["train"]["logs"][f"{stage}_tp"]
              if "total_loss" in r]
    assert len(losses) >= 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("stage", ["rq", "dec"])
def test_tp_checkpoint_is_whole_and_restores_into_one_process(runs, stage):
    root = runs["root"]
    got, meta = checkpoint.restore(str(root / f"{stage}_tp1x2"), device="cpu")
    want, wmeta = checkpoint.restore(str(root / f"{stage}_one"), device="cpu")
    assert meta["step"] == wmeta["step"]
    assert tree_shapes(got["params"]) == tree_shapes(want["params"])
    assert tree_shapes(got["opt_state"].mu) == tree_shapes(want["params"])
    assert got["opt_state"].count == want["opt_state"].count
    # 1e-3 of each leaf's max-abs (PERF.md's bound for two runs of a decoder
    # step that sum in other orders): Adam's update turns the gradients'
    # last-bit differences into differences of up to ~1e-3 of the lr
    for (p, a), (_, b) in zip(tree_leaves_with_path(got["params"]),
                              tree_leaves_with_path(want["params"])):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-3 * scale, (p, float((a - b).abs().max()), scale)
    # and a one-process checkpoint restores into the (1, 2) shards
    if stage == "rq":
        logs = runs["ranks"][2][0]["train"]["logs"]
        cfg = _stage1_cfg(root, "rq_one").model_config()
        x = torch.from_numpy(np.random.RandomState(2).randn(16, 16).astype(np.float32))
        one = float(trq.forward(want["params"], cfg, x, gumbel_t=0.2).loss)
        np.testing.assert_allclose(logs["restored_eval_loss"], one, rtol=1e-5)
        assert dict(logs["restored_shapes"])[("layers", 0, "codebook")] == (8, 8)


def test_run_eval_on_a_model_axis_equals_one_process(runs):
    one = runs["one_eval"]
    evs = [res["train"]["eval"] for res in runs["ranks"][4]]
    assert all(ev == evs[0] for ev in evs)
    assert one["n_users"] == evs[0]["n_users"] > 8
    for k, v in one.items():
        if isinstance(v, float):
            np.testing.assert_allclose(evs[0][k], v, rtol=1e-6, atol=1e-6, err_msg=k)


# ---- heads that do not divide over the model axis: 6 heads at (1, 4) ----

def _whole_heads(runs):
    return [res["whole_heads"] for res in runs["ranks"][4]]


def test_whole_heads_layout_and_round_trip(runs):
    import jax

    from rqvae_tpu.models import retrieval as jret
    from rqvae_tpu.parallel import mesh as jmesh

    whole = runs["inputs"]["params6"]
    jcfg = jret.RetrievalConfig(**H6_FIELDS)
    jtree = jax.eval_shape(lambda: jret.init(jax.random.PRNGKey(0), jcfg))
    jspecs = {jmesh._path_str(kp): jmesh._retrieval_tp_spec(jmesh._path_str(kp), leaf)
              for kp, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    m = H6_MESH[1]
    for res in _whole_heads(runs):
        assert res["tp"] == m and not res["split"] and res["local_heads"] == 6
        local = dict(res["local_shapes"])
        n_whole = n_split = 0
        for path, leaf in tree_leaves_with_path(whole):
            p = mesh.path_str(path)
            want = list(leaf.shape)
            if any(k in f"/{p}" for k in ("/attn/", "/cross_attn/")):
                n_whole += leaf.ndim == 2     # whole on every rank
            elif "model" in tuple(jspecs[p]):
                dim = tuple(jspecs[p]).index("model")   # JAX's dimension, a quarter of it
                want[dim] //= m
                n_split += 1
            assert local[path] == tuple(want), (p, local[path], want)
        assert n_whole == 2 * 2 + 2 * 5 and n_split >= 8   # encoder 2 a layer, decoder 5
        assert res["moment_shapes"] == res["local_shapes"]
        for (p, a), (_, b) in zip(tree_leaves_with_path(res["roundtrip"]),
                                  tree_leaves_with_path(whole)):
            assert torch.equal(a, b), p


@pytest.mark.parametrize("path", ["flat", "packed"])
def test_whole_heads_gradients_match_jax_unsharded(runs, path):
    import jax
    import jax.numpy as jnp

    from rqvae_tpu.models import retrieval as jret
    from rqvae_tpu.tokenizer import semids as jsem

    jcfg = jret.RetrievalConfig(**H6_FIELDS)
    if path == "flat":
        from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch

        jtok = JBatch(**{k: jnp.asarray(v) for k, v in _flat_batch().items()})
        fn = lambda p: jret.forward(p, jcfg, jtok).loss  # noqa: E731
    else:
        tok = _cat(runs["inputs"]["packed"])
        jtok = jsem.PackedTokenizedBatch(*(jnp.asarray(t.numpy()) for t in tok))
        fn = lambda p: jret.forward_packed(p, jcfg, jtok).loss  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(fn))(jax.tree.map(jnp.asarray, runs["jp6"]))
    for res in _whole_heads(runs):
        tloss, tgrads = res[path]
        np.testing.assert_allclose(tloss, float(loss), rtol=2e-5)
        _assert_tree_close(tgrads, jax.device_get(grads), rtol=2e-5, atol=1e-6)


def test_whole_heads_collectives_and_beam_search(runs):
    want = _flat_step_collectives(H6CFG.n_layers // 2, H6CFG.n_layers // 2, heads_split=False)
    inputs = runs["inputs"]
    index = tsem.build_index(torch.from_numpy(inputs["cached"]), K)
    one = tgen.generate_next_sem_ids(inputs["params6"], H6CFG, index, inputs["flat"]._replace(
        sem_ids_fut=None, token_type_ids_fut=None), k=4, n_candidates=K)
    lp = one.log_probas.numpy()
    apart = np.all(np.abs(np.diff(lp, axis=1)) > 1e-4, axis=1)
    assert apart.sum() >= GLOBAL_ROWS // 2
    for res in _whole_heads(runs):
        assert res["flat_calls"] == want
        ids, logp = res["beam"]
        np.testing.assert_array_equal(ids.numpy()[apart], one.sem_ids.numpy()[apart])
        np.testing.assert_allclose(logp.numpy(), lp, rtol=1e-5, atol=1e-5)


def test_uneven_leaf_still_raises(runs):
    for res in _whole_heads(runs):
        uneven, no_heads = res["raises"]
        assert uneven is not None and "does not divide over a model axis of 4" in uneven
        assert no_heads is not None and "heads" in no_heads


def test_whole_heads_train_loop_and_checkpoint_equal_one_process(runs):
    want = runs["one"]["dec_h6_one"].records
    for res in _whole_heads(runs):
        common = _common_losses(res["train"], want)
        assert len(common) >= 10
        for key, (a, b) in common.items():
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=str(key))
    root = runs["root"]
    got, meta = checkpoint.restore(str(root / "dec_h6_tp"), device="cpu")
    one, wmeta = checkpoint.restore(str(root / "dec_h6_one"), device="cpu")
    assert meta["step"] == wmeta["step"]
    assert tree_shapes(got["params"]) == tree_shapes(one["params"])
    assert tree_shapes(got["opt_state"].mu) == tree_shapes(one["params"])
    for (p, a), (_, b) in zip(tree_leaves_with_path(got["params"]),
                              tree_leaves_with_path(one["params"])):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-3 * scale, (p, float((a - b).abs().max()), scale)


def test_whole_heads_run_eval_equals_one_process(runs):
    one = runs["one_eval_h6"]
    evs = [res["eval"] for res in _whole_heads(runs)]
    assert all(ev == evs[0] for ev in evs)
    assert one["n_users"] == evs[0]["n_users"] > 8
    for k, v in one.items():
        if isinstance(v, float):
            np.testing.assert_allclose(evs[0][k], v, rtol=1e-6, atol=1e-6, err_msg=k)


if __name__ == "__main__":
    _worker(pathlib.Path(sys.argv[1]))
