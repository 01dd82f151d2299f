"""Data parallelism in the port (``parallel/mesh.py`` and its users) on the
CPU: two gloo processes, launched as subprocesses of this file with
``torchrun``'s variables (a free port, a timeout of their own), against one
process over the whole batch.

* the steps: the flat, bucketed, packed (with unequal valid slots across the
  ranks) and stage-1 steps, and the stage-1 device chunk, each over a global
  batch split in two, against one process over the whole batch: gradients
  ``rtol=1e-5, atol=1e-6`` (JAX's ``tests/test_sharding.py`` tolerance),
  losses ``rtol=1e-5``;
* ``maybe_init_distributed`` from the environment alone, ``make_mesh``
  taking a model axis (tensor parallelism: test_torch_tensor_parallel.py)
  and refusing a shape that does not cover the world;
* ``train()`` of both stages with ``mesh_shape=(2, 1)``: replicated metrics
  equal across the ranks to ``rtol=1e-6``, checkpoints written by rank 0
  only, ``rqvae_entropy`` logged by rank 0 only (JAX's
  ``tests/test_multiprocess.py``), then ``run_eval`` over the two ranks equal
  to one process with exhaustive candidates to 1e-6;
* with span recording on, ``all_reduce_`` records a ``comm.all_reduce`` span
  and counts the bytes it reduced, and nothing when no data mesh acts.

Run alone: ``python -m pytest tests/test_torch_distributed.py -q`` (~30 s).
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:   # run as a worker: python tests/test_torch_distributed.py
    sys.path.insert(0, str(REPO))

from rqvae_tpu_torch.data.schemas import SeqBatch  # noqa: E402
from rqvae_tpu_torch.evaluate import run_eval  # noqa: E402
from rqvae_tpu_torch.models import retrieval, rqvae  # noqa: E402
from rqvae_tpu_torch.parallel import mesh  # noqa: E402
from rqvae_tpu_torch.utils import profiling  # noqa: E402
from rqvae_tpu_torch.tokenizer import semids  # noqa: E402
from rqvae_tpu_torch.train import checkpoint, optim  # noqa: E402
from rqvae_tpu_torch.train import train_decoder as ttd  # noqa: E402
from rqvae_tpu_torch.train import train_rqvae as ttr  # noqa: E402
from rqvae_tpu_torch.utils import config as tconfig  # noqa: E402
from rqvae_tpu_torch.utils.logging import MetricsLogger  # noqa: E402
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path, tree_map  # noqa: E402

WORLD = 2
K = 16
N_ITEMS = 60
N_HIST = 12
CFG = retrieval.RetrievalConfig(embedding_dim=16, attn_dim=32, dropout=0.0, num_heads=2,
                                n_layers=2, num_embeddings=K, sem_id_dim=4, max_pos=N_HIST * 4,
                                input_dropout=0.0, mlp_hidden_dim=32)
RQ_CFG = rqvae.RqVaeConfig(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=16,
                           n_layers=2, n_cat_feats=0, codebook_mode="ROTATION_TRICK")
GLOBAL_ROWS = 8
PACK_CROPS = (slice(0, 10), slice(10, 12))   # a rank's crops: 10 and 2 valid slots


class _CaptureGrads:
    def update(self, params, state, grads):
        return grads


class _Capture(MetricsLogger):
    def __init__(self):
        super().__init__(every=1)
        self.records = []

    def log(self, step, metrics, force=False):
        self.records.append({"step": step, **{k: float(np.asarray(v)) for k, v in metrics.items()}})


# ---- shared data, made alike in every process ----

def _decoder_setup():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, K, (N_ITEMS, 3)).astype(np.int32)
    cached = np.concatenate([ids, np.zeros((N_ITEMS, 1), np.int32)], axis=1)
    cached[:, -1] = semids.dedup_column(torch.from_numpy(ids), K).numpy()
    index = semids.build_index(torch.from_numpy(cached), K)
    params = retrieval.init(torch.Generator().manual_seed(0), CFG, device="cpu")
    return index, params


def _seq_batch(rows, lead=True):
    rng = np.random.RandomState(1)
    lengths = rng.randint(1, N_HIST + 1, GLOBAL_ROWS)
    ids = rng.randint(0, N_ITEMS, (GLOBAL_ROWS, N_HIST)).astype(np.int32)
    ids = np.where(np.arange(N_HIST)[None] < lengths[:, None], ids, -1)[rows]
    fut = rng.randint(0, N_ITEMS, (GLOBAL_ROWS, 1)).astype(np.int32)[rows]
    arrays = dict(user_ids=np.arange(GLOBAL_ROWS, dtype=np.int32)[rows] * 7, ids=ids,
                  ids_fut=fut, x=np.zeros(ids.shape + (1,), np.float32),
                  x_fut=np.zeros(fut.shape + (1,), np.float32), seq_mask=ids >= 0)
    return SeqBatch(**{k: torch.from_numpy(np.ascontiguousarray(v[None] if lead else v))
                       for k, v in arrays.items()})


def _packed(sel):
    """The crops ``sel`` of one fixed list of 12, packed into 6 rows."""
    from rqvae_tpu_torch.data import packing

    rng = np.random.RandomState(4)
    crops = [(int(rng.randint(0, 500)), rng.randint(0, N_ITEMS, rng.randint(3, 9)).astype(np.int32),
              int(rng.randint(0, N_ITEMS))) for _ in range(12)][sel]
    batch, left = packing.pack_crops(crops, rows=6, slots=4, capacity=N_HIST * 2)
    assert not left
    return packing.to_device(batch, "cpu")


def _stage1_x():
    return torch.from_numpy(np.random.RandomState(2).randn(16, 16).astype(np.float32))


def _rq_params():
    return rqvae.init(torch.Generator().manual_seed(3), RQ_CFG, device="cpu")


def _steps(rank_rows, packed_counts, x_rows):
    """Every step's (loss metrics, grads) on the given rows; the caller's
    mesh decides whether the gradients are reduced."""
    index, params = _decoder_setup()
    out = {}
    step = ttd.make_train_step(CFG, _CaptureGrads(), index, 1, torch.float32, 4)
    _, grads, m = step(params, None, _seq_batch(rank_rows), None)
    out["flat"] = (ttd._replicated(m, "mean"), grads)
    grad_accum, apply = ttd.make_bucketed_fns(CFG, _CaptureGrads(), index, torch.float32, 4)
    raw = _seq_batch(rank_rows, lead=False)
    acc = tree_map(torch.zeros_like, params)
    loss, loss_d = torch.zeros(()), torch.zeros(4)
    lengths = raw.seq_mask.sum(1).numpy()
    for rows, length in ttd.bucket_slices(lengths, 2):
        sub = SeqBatch(*(t[torch.from_numpy(rows)] for t in raw))
        sub = sub._replace(ids=sub.ids[:, :length], x=sub.x[:, :length],
                           seq_mask=sub.seq_mask[:, :length])
        acc, loss, loss_d = grad_accum(params, acc, loss, loss_d, sub, None, 0.5)
    _, grads = apply(params, None, acc)
    out["bucketed"] = (ttd._replicated({"total_loss": loss, "loss_d": loss_d}, "mean"), grads)
    pstep = ttd.make_packed_step(CFG, _CaptureGrads(), index, torch.float32)
    _, grads, m = pstep(params, None, _packed(packed_counts), None)
    out["packed"] = (ttd._replicated(m, "sum"), grads)
    rstep = ttr.make_train_step(RQ_CFG, _CaptureGrads(), 1, torch.float32)
    _, grads, m = rstep(_rq_params(), None, _stage1_x()[x_rows][None], None, 0.2)
    m = {k: m[k] for k in ("total_loss", "reconstruction_loss", "rqvae_loss", "embs_norm_mean")}
    out["stage1"] = (ttr._replicated(m, "mean"), grads)
    opt = optim.adamw(1e-2, 0.01)
    p = _rq_params()
    chunk = ttr.make_device_chunk(RQ_CFG, opt, 1, torch.float32, 16, 3)
    p, state, m = chunk(p, opt.init(p), _stage1_x().repeat(4, 1), torch.Generator().manual_seed(9),
                        0.2, torch.Generator().manual_seed(5))
    m = {k: m[k] for k in ("total_loss", "reconstruction_loss", "rqvae_loss")}
    out["chunk"] = (ttr._replicated(m, "mean"), p)
    return out


# ---- the workers ----

def _worker_steps(out_dir: pathlib.Path):
    world = mesh.maybe_init_distributed("cpu")          # from torchrun's variables alone
    r = mesh.rank()
    res = {"world": world, "again": mesh.maybe_init_distributed("cpu"),
           "backend": torch.distributed.get_backend(),
           "rank_sum": None, "refusals": []}
    tp = mesh.make_mesh((1, 2), tensor_parallel=True)   # a model axis: tensor parallelism
    res["tp_mesh"] = (tp.data, tp.model, tp.tp, tp.model_index, mesh.dispatch.model_axis_size())
    try:
        mesh.make_mesh((4, 1))
    except ValueError as e:
        res["refusals"].append(str(e))
    mesh.make_mesh((WORLD, 1))
    res["rank_sum"] = float(mesh.all_reduce_([torch.tensor([float(r + 1)])], "sum")[0])
    half = GLOBAL_ROWS // WORLD
    res["steps"] = _steps(np.arange(r * half, (r + 1) * half), PACK_CROPS[r],
                          slice(r * 8, (r + 1) * 8))
    mesh.collective_calls = 0
    with mesh.dispatch.local_execution():
        mesh.all_reduce_([torch.ones(3)], "sum")
        mesh.barrier()
    res["local_collectives"] = mesh.collective_calls
    profiling.enable()
    mesh.all_reduce_([torch.ones(3), torch.ones(2)], "sum")
    with mesh.dispatch.local_execution():
        mesh.all_reduce_([torch.ones(3)], "sum")
    got = profiling.collect()
    profiling.disable()
    res["recorded"] = ([s[0] for s in got["spans"]], got["counters"])
    torch.save(res, out_dir / f"steps_r{r}.pt")


def _stage1_cfg(root, **kw):
    return tconfig.from_dict(ttr.RqVaeTrainConfig, dict(
        iterations=8, batch_size=16, learning_rate=1e-3, dataset="SYNTHETIC", vae_input_dim=16,
        vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=16, vae_n_cat_feats=0,
        vae_n_layers=3, vae_codebook_mode="ROTATION_TRICK", eval_every=8, save_model_every=8,
        save_dir_root=str(root / "rq"), log_every=4, synthetic_n_items=300,
        kmeans_prime_items=200, eval_batches=2, seed=0, steps_per_call=4, **kw))


def _decoder_cfg(root, **kw):
    return tconfig.from_dict(ttd.DecoderTrainConfig, dict(
        dataset="SYNTHETIC", vae_input_dim=16, vae_hidden_dims=(16,), vae_embed_dim=8,
        vae_codebook_size=16, vae_n_cat_feats=0, vae_n_layers=3,
        vae_codebook_mode="ROTATION_TRICK", synthetic_n_items=300, seed=0, iterations=6,
        batch_size=8, learning_rate=1e-3, pretrained_rqvae_path=str(root / "rq"),
        save_dir_root=str(root / "dec"), synthetic_n_users=120, attn_embed_dim=32,
        attn_heads=2, attn_layers=2, decoder_embed_dim=16, dropout_p=0.0, log_every=3,
        partial_eval_every=6, full_eval_every=6, eval_batches=2, warmup_steps=10,
        generation_top_k=4, generation_candidates=16, amp=False, **kw))


def _worker_train(out_dir: pathlib.Path):
    writes = []
    real = checkpoint._write_atomic
    checkpoint._write_atomic = lambda path, write: writes.append(path) or real(path, write)
    logs = {}
    for name, fn, cfg in (("rq", ttr.train, _stage1_cfg(out_dir, mesh_shape=(WORLD, 1))),
                          ("dec", ttd.train, _decoder_cfg(out_dir, mesh_shape=(WORLD, 1)))):
        cap = _Capture()
        fn(cfg, logger=cap, device="cpu")
        logs[name] = cap.records
    ev = run_eval.evaluate_checkpoint(_decoder_cfg(out_dir, mesh_shape=(WORLD, 1)),
                                      split="eval", device="cpu")
    torch.save({"logs": logs, "eval": ev, "writes": len(writes)},
               out_dir / f"train_r{mesh.rank()}.pt")


# ---- the launcher ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(kind: str, out_dir: pathlib.Path, timeout: int = 300):
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("RQVAE_TPU_DISABLE_PALLAS", None)
        procs.append(subprocess.Popen([sys.executable, __file__, kind, str(out_dir)], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{kind} workers did not finish in {timeout} s (mismatched "
                             "collectives?)")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(out_dir / f"{kind}_r{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    ranks = _launch("steps", tmp_path_factory.mktemp("dp_steps"))
    saved = mesh.dispatch.execution_mesh()
    mesh.dispatch.set_execution_mesh(None)
    try:   # one process over the whole batch: both ranks' rows and crops
        want = _steps(np.arange(GLOBAL_ROWS), slice(0, 12), slice(0, 16))
    finally:
        mesh.dispatch.set_execution_mesh(saved)
    return ranks, want


def test_init_from_the_environment_and_mesh_refusals(step_runs):
    ranks, _ = step_runs
    for res in ranks:
        assert res["world"] == res["again"] == WORLD and res["backend"] == "gloo"
        assert res["rank_sum"] == 3.0
        assert res["tp_mesh"][:3] == (1, 2, 2) and res["tp_mesh"][4] == 2
        assert len(res["refusals"]) == 1 and "(4, 1)" in res["refusals"][0]
        assert res["local_collectives"] == 0     # identities under local_execution


def test_all_reduce_records_its_span_and_bytes(step_runs):
    """Recording on: the data mesh's all-reduce of 5 fp32 values records one
    ``comm.all_reduce`` span and 20 bytes; under ``local_execution``, where
    no data mesh acts, it records nothing."""
    ranks, _ = step_runs
    for res in ranks:
        assert res["recorded"] == (["comm.all_reduce"], {"comm.all_reduce_bytes": 20})


@pytest.mark.parametrize("name", ["flat", "bucketed", "packed", "stage1", "chunk"])
def test_step_on_a_split_batch_equals_one_process(step_runs, name):
    ranks, want = step_runs
    w_metrics, w_tree = want[name]
    for res in ranks:
        metrics, tree = res["steps"][name]
        for k, v in w_metrics.items():
            np.testing.assert_allclose(metrics[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        got, exp = list(tree_leaves_with_path(tree)), list(tree_leaves_with_path(w_tree))
        assert [p for p, _ in got] == [p for p, _ in exp]
        for (path, a), (_, b) in zip(got, exp):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=str(path))


def test_packed_ranks_hold_unequal_valid_slots():
    counts = [int(_packed(c).slot_valid.sum()) for c in PACK_CROPS + (slice(0, 12),)]
    assert counts == [10, 2, 12]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_train")
    return root, _launch("train", root)


def _common(records_a, records_b):
    keyed = [{(k, r["step"]): v for r in recs for k, v in r.items() if k != "step"}
             for recs in (records_a, records_b)]
    return {k: (keyed[0][k], keyed[1][k]) for k in set(keyed[0]) & set(keyed[1])}


@pytest.mark.parametrize("stage", ["rq", "dec"])
def test_train_replicated_metrics_agree_across_ranks(train_runs, stage):
    _, ranks = train_runs
    common = _common(ranks[0]["logs"][stage], ranks[1]["logs"][stage])
    compared = [k for k in common if "examples_per_s" not in k[0] and "seq_length" not in k[0]]
    assert len(compared) > 10
    for key in compared:
        a, b = common[key]
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=str(key))
    losses = [r["total_loss"] for r in ranks[0]["logs"][stage] if "total_loss" in r]
    assert len(losses) >= 3 and np.isfinite(losses).all()


def test_rank0_alone_writes_checkpoints_and_diversity_metrics(train_runs):
    root, ranks = train_runs
    assert ranks[0]["writes"] > 0 and ranks[1]["writes"] == 0
    keys = [{k for r in res["logs"]["rq"] for k in r} for res in ranks]
    assert "rqvae_entropy" in keys[0] and "rqvae_entropy" not in keys[1]
    assert checkpoint.latest_step(str(root / "rq")) == 7
    assert checkpoint.latest_step(str(root / "dec")) == 5
    assert not list(root.rglob("*.tmp"))


def test_run_eval_over_two_ranks_equals_one_process(train_runs):
    root, ranks = train_runs
    saved = mesh.dispatch.execution_mesh()
    try:
        one = run_eval.evaluate_checkpoint(_decoder_cfg(root), split="eval", device="cpu")
    finally:
        mesh.dispatch.set_execution_mesh(saved)
    assert ranks[0]["eval"] == ranks[1]["eval"]
    assert one["n_users"] == ranks[0]["eval"]["n_users"] > 8
    for k, v in one.items():
        if isinstance(v, float):
            np.testing.assert_allclose(ranks[0]["eval"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    assert any(v > 0 for k, v in one.items() if k.startswith("h@"))


def test_one_process_runs_no_collective(tmp_path):
    """No group: the step and the loop's reductions issue no collective."""
    mesh.collective_calls = 0
    index, params = _decoder_setup()
    ttd.make_train_step(CFG, _CaptureGrads(), index, 1, torch.float32, 4)(
        params, None, _seq_batch(np.arange(4)), None)
    ttr.train(dataclasses.replace(_stage1_cfg(tmp_path), iterations=4, mesh_shape=(1, 1)),
              logger=_Capture(), device="cpu")
    assert mesh.collective_calls == 0 and mesh.world_size() == 1


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"steps": _worker_steps, "train": _worker_train}[sys.argv[1]](pathlib.Path(sys.argv[2]))
