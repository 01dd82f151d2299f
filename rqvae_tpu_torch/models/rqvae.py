"""RQ-VAE: MLP autoencoder with a residual-quantization bottleneck
(counterpart of rqvae_tpu/models/rqvae.py), eval / tokenize path.

Ported: config, ``init``, ``encode``, ``decode``, ``effective_codebooks``,
``get_semantic_ids`` (eval mode) and ``encode_and_tokenize``, which routes
through the ``rq_tokenize`` kernel wrapper (CUDA kernel on the GPU, its
plain twin on the CPU). Training and k-means priming are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from rqvae_tpu_torch.models import mlp, quantize
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.ops.quantize_kernels import rq_tokenize
from rqvae_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RqVaeConfig:
    input_dim: int = 18
    embed_dim: int = 16
    hidden_dims: Tuple[int, ...] = (18, 18)
    codebook_size: int = 32
    n_layers: int = 3
    n_cat_feats: int = 18
    commitment_weight: float = 0.25
    codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX
    codebook_normalize: bool = False
    codebook_sim_vq: bool = False
    codebook_kmeans_init: bool = True

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        if isinstance(self.codebook_mode, str):
            object.__setattr__(self, "codebook_mode", QuantizeForwardMode[self.codebook_mode])


class RqVaeOutput(NamedTuple):
    embeddings: torch.Tensor     # (B, D, L)
    residuals: torch.Tensor      # (B, D, L)
    sem_ids: torch.Tensor        # (B, L) int32
    quantize_loss: torch.Tensor  # (B,)


def init(gen: torch.Generator, cfg: RqVaeConfig, *, device=None):
    """Random parameters with the JAX pytree layout; on ``cuda`` unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    return {
        "encoder": mlp.init(gen, cfg.input_dim, cfg.hidden_dims, cfg.embed_dim, device=dev),
        "decoder": mlp.init(gen, cfg.embed_dim, tuple(reversed(cfg.hidden_dims)),
                            cfg.input_dim, device=dev),
        "layers": [
            quantize.init(gen, cfg.codebook_size, cfg.embed_dim,
                          sim_vq=cfg.codebook_sim_vq, device=dev)
            for _ in range(cfg.n_layers)
        ],
    }


def encode(params, cfg: RqVaeConfig, x: torch.Tensor) -> torch.Tensor:
    return mlp.apply(params["encoder"], x, normalize=cfg.codebook_normalize)


def decode(params, cfg: RqVaeConfig, z: torch.Tensor) -> torch.Tensor:
    return mlp.apply(params["decoder"], z, normalize=True)


def _level_normalize(cfg: RqVaeConfig, level: int) -> bool:
    # only level 0 normalizes its codebook
    return level == 0 and cfg.codebook_normalize


def get_semantic_ids(params, cfg: RqVaeConfig, x: torch.Tensor, *,
                     training: bool = False) -> RqVaeOutput:
    """Encode then quantize through n_layers levels (eval mode)."""
    if training:
        raise NotImplementedError("RQ-VAE training is not ported yet")
    res = encode(params, cfg, x)
    embs, residuals, sem_ids = [], [], []
    q_loss = torch.zeros(res.shape[:-1], dtype=res.dtype, device=res.device)
    for level in range(cfg.n_layers):
        residuals.append(res)
        out = quantize.apply(
            params["layers"][level], res,
            normalize=_level_normalize(cfg, level),
            commitment_weight=cfg.commitment_weight,
        )
        q_loss = q_loss + out.loss
        res = res - out.embeddings
        embs.append(out.embeddings)
        sem_ids.append(out.ids)
    return RqVaeOutput(
        embeddings=torch.stack(embs, dim=-1),
        residuals=torch.stack(residuals, dim=-1),
        sem_ids=torch.stack(sem_ids, dim=-1),
        quantize_loss=q_loss,
    )


def effective_codebooks(params, cfg: RqVaeConfig) -> torch.Tensor:
    """(L, K, D) stack of post-SimVQ / post-norm codebooks."""
    return torch.stack([
        quantize.effective_codebook(params["layers"][level],
                                    normalize=_level_normalize(cfg, level))
        for level in range(cfg.n_layers)
    ], dim=0)


def encode_and_tokenize(params, cfg: RqVaeConfig, x: torch.Tensor) -> torch.Tensor:
    """Hard-argmin tokenization: encoder MLP + the fused RQ kernel, in fp32.
    Same ids as ``get_semantic_ids(...).sem_ids`` up to near-ties (the kernel
    orders the distance terms as the TPU kernel does)."""
    z = encode(params, cfg, x).float().contiguous()
    cbs = effective_codebooks(params, cfg).float().contiguous()
    return rq_tokenize(z, cbs, commitment_weight=cfg.commitment_weight).sem_ids
