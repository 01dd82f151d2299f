"""The port's mirror of the train loops of ``tests/test_sharding.py``
(``test_decoder_train_loop_tensor_parallel``,
``test_rqvae_train_loop_tensor_parallel`` and
``test_full_dp_train_loop_on_mesh``), which JAX runs on 8 virtual CPU
devices: here 8 gloo ranks, subprocesses of this file with ``torchrun``'s
variables (``python tests/test_torch_e2e_sharding.py <dir>``), run the real
loops on the CPU at mesh (4, 2) with ``tensor_parallel=True`` and at (8, 1).
Every rank's losses must be finite and every rank must log the same
values (the metrics are reduced over the data group)."""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:   # run as a worker: python tests/test_torch_e2e_sharding.py
    sys.path.insert(0, str(REPO))

from rqvae_tpu_torch.parallel import mesh  # noqa: E402
from rqvae_tpu_torch.train import train_decoder, train_rqvae  # noqa: E402
from rqvae_tpu_torch.utils.config import from_dict  # noqa: E402

pytestmark = pytest.mark.slow  # heavy end-to-end/train-loop suite (run: pytest -m slow)

WORLD = 8


class Collect:
    def __init__(self):
        self.records = []

    def log(self, step, metrics, force=False):
        self.records.append({"step": step, **{k: float(np.asarray(v)) for k, v in metrics.items()
                                              if np.ndim(v) == 0}})


def _worker(out: pathlib.Path):
    torch.set_num_threads(1)
    assert mesh.maybe_init_distributed("cpu") == WORLD
    res = {}
    # test_decoder_train_loop_tensor_parallel
    rq_cfg = from_dict(train_rqvae.RqVaeTrainConfig, dict(
        iterations=5, batch_size=16, dataset="SYNTHETIC", vae_input_dim=16,
        vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=16, vae_n_cat_feats=0,
        eval_every=1000, save_model_every=5, save_dir_root=str(out / "rq"),
        synthetic_n_items=128, synthetic_n_users=64, kmeans_prime_items=64, do_eval=False,
        log_every=5))
    train_rqvae.train(rq_cfg, device="cpu", logger=Collect())
    dec = Collect()
    dec_cfg = from_dict(train_decoder.DecoderTrainConfig, dict(
        iterations=6, batch_size=16, dataset="SYNTHETIC", pretrained_rqvae_path=str(out / "rq"),
        vae_input_dim=16, vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=16,
        vae_n_cat_feats=0, decoder_embed_dim=16, attn_embed_dim=32, attn_heads=4,
        attn_layers=4, save_dir_root=str(out / "dec"), synthetic_n_items=128,
        synthetic_n_users=64, partial_eval_every=6, full_eval_every=1000, eval_batches=1,
        mesh_shape=(4, 2), tensor_parallel=True, log_every=2, generation_top_k=8,
        generation_candidates=16))
    train_decoder.train(dec_cfg, device="cpu", logger=dec)
    res["decoder_tp"] = dec.records
    # test_rqvae_train_loop_tensor_parallel
    rq = Collect()
    cfg = from_dict(train_rqvae.RqVaeTrainConfig, dict(
        iterations=8, batch_size=16, dataset="SYNTHETIC", vae_input_dim=16,
        vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=16, vae_n_cat_feats=0,
        eval_every=8, save_model_every=1000, save_dir_root=str(out / "o_tp"),
        synthetic_n_items=128, synthetic_n_users=64, kmeans_prime_items=64, do_eval=True,
        eval_batches=1, mesh_shape=(4, 2), tensor_parallel=True, log_every=4))
    train_rqvae.train(cfg, device="cpu", logger=rq)
    res["rqvae_tp"] = rq.records
    # test_full_dp_train_loop_on_mesh
    dp = Collect()
    cfg = from_dict(train_rqvae.RqVaeTrainConfig, dict(
        iterations=10, batch_size=32, dataset="SYNTHETIC", vae_input_dim=16,
        vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=16, vae_n_cat_feats=0,
        eval_every=1000, save_model_every=1000, save_dir_root=str(out / "o_dp"),
        synthetic_n_items=128, synthetic_n_users=64, kmeans_prime_items=128, do_eval=False,
        mesh_shape=(8, 1), log_every=5))
    train_rqvae.train(cfg, device="cpu", logger=dp)
    res["rqvae_dp"] = dp.records
    torch.save(res, out / f"r{mesh.rank()}.pt")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_loops_on_eight_ranks(tmp_path):
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, __file__, str(tmp_path)], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = [torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(WORLD)]
    for name in ("decoder_tp", "rqvae_tp", "rqvae_dp"):
        losses = [[x["total_loss"] for x in res[name] if "total_loss" in x] for res in ranks]
        assert losses[0] and np.isfinite(losses[0]).all(), (name, losses[0])
        for other in losses[1:]:
            np.testing.assert_allclose(other, losses[0], rtol=1e-6, err_msg=name)
    assert any("eval_loss" in x for x in ranks[0]["decoder_tp"])
    assert any("eval_total_loss" in x for x in ranks[0]["rqvae_tp"])


if __name__ == "__main__":
    _worker(pathlib.Path(sys.argv[1]))
