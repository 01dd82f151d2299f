"""Standalone generative evaluation (the port's counterpart of
rqvae_tpu/evaluate/run_eval.py): load a decoder checkpoint and run the full
constrained-beam-search eval on the eval or the test split.

  python -m rqvae_tpu_torch.evaluate.run_eval configs/decoder_amazon.json \\
      --split test [--checkpoint out/decoder/amazon/] [--step N] \\
      [--max-users 2048] [--seed 0] [--device cpu] [key=value ...]

Loads the decoder from ``--checkpoint`` (default: the config's
``save_dir_root``; ``--step`` or the latest), the frozen RQ-VAE from the
config's ``pretrained_rqvae_path``, tokenizes the corpus (``rq_tokenize`` on
the GPU), and runs the padded-tail beam-search eval of the train loop
(``train_decoder.run_generative_eval``, ``children_window``'s ``Mask``
epilogue once a level), printing one JSON line of h@{1,5,10} / NDCG
metrics. On the GPU unless ``device="cpu"`` is passed; under ``torchrun``
(``torchrun --nproc_per_node=N -m rqvae_tpu_torch.evaluate.run_eval ...``)
each data replica scores its block of every batch of users and the metrics
are summed over the data group, so every rank prints the same line, equal to
one process's. ``mesh_shape`` may hold a model axis: its ranks keep the
parameters whole and score the same rows, as JAX's ``run_eval`` keeps them
replicated (``dp_param_shardings``) whatever the config's
``tensor_parallel``.
"""
from __future__ import annotations

import json
import sys
from typing import Optional

import torch

from rqvae_tpu_torch.data import dataset as dataset_lib
from rqvae_tpu_torch.data import registry
from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.parallel import mesh as mesh_lib
from rqvae_tpu_torch.tokenizer import semids
from rqvae_tpu_torch.train import checkpoint as ckpt_lib
from rqvae_tpu_torch.train import train_decoder
from rqvae_tpu_torch.utils import config as config_lib
from rqvae_tpu_torch.utils.device import resolve_device


def evaluate_checkpoint(
    cfg: train_decoder.DecoderTrainConfig,
    *,
    split: str = "eval",
    checkpoint: Optional[str] = None,
    step: Optional[int] = None,
    max_users: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> dict:
    """h@k / NDCG of the decoder checkpoint over the first ``max_users`` rows
    of ``split``, plus ``split``, ``n_users`` and ``checkpoint_step``. The
    candidate noise (when ``generation_candidates`` is below the codebook
    size) draws from a device generator seeded with ``seed``."""
    dev = resolve_device(device)
    mesh_lib.maybe_init_distributed(dev)
    bundle = registry.load(
        cfg.dataset,
        cfg.data_path or cfg.dataset_folder,
        split=cfg.dataset_split if cfg.dataset == registry.RecDataset.AMAZON else None,
        synthetic_kwargs={"n_items": cfg.synthetic_n_items, "feature_dim": cfg.vae_input_dim,
                          "n_users": cfg.synthetic_n_users, "seed": cfg.seed},
    )
    seqs = {"eval": bundle.eval_seqs, "test": bundle.test_seqs}[split]
    if seqs is None:
        raise SystemExit(f"no '{split}' sequences in the dataset artifacts")

    model_cfg = cfg.retrieval_config(bundle.max_seq_len)
    vae_params, vae_cfg = train_decoder.load_frozen_rqvae(cfg, device=dev)
    with dispatch.local_execution():   # the whole frozen RQ-VAE on every rank
        index = semids.precompute_corpus_ids(
            vae_params, vae_cfg,
            torch.from_numpy(dataset_lib.features_for_model(bundle.items.x,
                                                            vae_cfg.input_dim)).to(dev))
    del vae_params

    # the params only: an opt_state in the checkpoint is read and dropped
    state, meta = ckpt_lib.restore(checkpoint or cfg.save_dir_root, step=step, device=dev)
    params = state["params"]
    del state
    print(f"---Loaded decoder iter {meta['step']}---", file=sys.stderr)

    mesh_lib.make_mesh(cfg.mesh_shape)   # whole parameters on every rank
    n_users = len(seqs) if max_users is None else min(max_users, len(seqs))
    gen = torch.Generator(device=dev).manual_seed(seed)
    metrics = train_decoder.run_generative_eval(params, model_cfg, index, seqs, bundle.items,
                                                cfg, gen, n_eval=n_users)
    metrics["split"] = split
    metrics["n_users"] = n_users
    metrics["checkpoint_step"] = int(meta["step"])
    return metrics


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="decoder train config (json)")
    p.add_argument("--split", default="eval", choices=["eval", "test"])
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (default: the config's save_dir_root)")
    p.add_argument("--step", type=int, default=None,
                   help="the checkpoint step to load (default: the latest under the "
                        "checkpoint dir)")
    p.add_argument("--max-users", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)

    cfg = config_lib.load_config(train_decoder.DecoderTrainConfig, args.config, args.overrides)
    metrics = evaluate_checkpoint(cfg, split=args.split, checkpoint=args.checkpoint,
                                  step=args.step, max_users=args.max_users, seed=args.seed,
                                  device=args.device)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
