"""RQ-VAE: MLP autoencoder with a residual-quantization bottleneck
(counterpart of rqvae_tpu/models/rqvae.py).

* ``encode`` / ``decode``: MLPs; the decoder ends in an l2-norm layer;
* ``get_semantic_ids``: n_layers sequential quantize levels, residual
  update res <- res - emb; in training, the hard estimators (STE, rotation
  trick) go through the fused ``rq_quantize_train`` kernel at every
  codebook volume (``FUSED_TRAIN_MIN_CODEBOOK_VOLUME`` is 0 in the port)
  where ``kernel_width`` holds, Gumbel-softmax and wider embeddings through
  the plain per-level loop of ``quantize.apply``;
* ``forward``: loss = mean(recon + sum of the levels' quantize losses), with
  the per-level embedding norms and the fraction of unique id tuples;
* ``kmeans_prime``: per-level k-means codebook init on a priming batch, where
  level i's k-means sees the residuals of level i-1's training-mode forward;
* ``encode_and_tokenize``: encoder + the ``rq_tokenize`` kernel.

The kernel wrappers run their CUDA kernels on the GPU and their plain twins
on the CPU, so a GPU run and a CPU run of one config take the same route.
With ``RQVAE_TPU_DISABLE_PALLAS=1`` (``ops/dispatch``) both quantizer routes
take the plain per-level loop, as JAX's do.

Under tensor parallelism (``parallel/tensor``; JAX's ``_rqvae_tp_spec``) the
encoder and decoder MLPs alternate column and row layers (``models/mlp``)
and each level's codebook is split by rows (``models/quantize``). The fused
training route is off then, as JAX's ``_fused_shardable`` turns it off: the
kernel needs the whole (L, K, D) stack, so a TP step launches no
``rq_quantize_train`` and takes the per-level loop. ``kmeans_prime`` and
``encode_and_tokenize`` take whole parameters (the callers gather them and
run these under ``dispatch.local_execution``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from rqvae_tpu_torch.models import kmeans as kmeans_lib
from rqvae_tpu_torch.models import mlp, quantize
from rqvae_tpu_torch.models.losses import categorical_reconstruction_loss
from rqvae_tpu_torch.models.normalize import l2norm
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.ops.quantize_kernels import MAX_D, rq_quantize_train, rq_tokenize
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


class RqVaeLosses(NamedTuple):
    loss: torch.Tensor                 # scalar
    reconstruction_loss: torch.Tensor  # scalar
    rqvae_loss: torch.Tensor           # scalar
    embs_norm: torch.Tensor            # (B, L)
    p_unique_ids: torch.Tensor         # scalar


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


def _level_kwargs(cfg: RqVaeConfig, level: int):
    return dict(
        mode=cfg.codebook_mode,
        # only level 0 normalizes its codebook
        normalize=(level == 0 and cfg.codebook_normalize),
        commitment_weight=cfg.commitment_weight,
    )


# codebook_size * embed_dim from which the hard estimators take the fused
# training kernel. The JAX package's 65,536 was measured on a TPU v5e. On an
# H100 (NVIDIA H100 80GB HBM3, 700.00 W) chip_smoke.py timed both routes
# through make_device_chunk, in ms a step, plain against fused: at the
# Amazon shape (3 x 256 x 32, batch 64, fp32) 11.35 / 9.37 against
# 8.53 / 7.97, at the stretch shape (4 x 2048 x 64, batch 1024, bf16)
# 13.50 / 13.40 against 11.85 / 10.79 (PERF.md, two runs). The fused route
# won at both, so every volume takes it. The name stays: tests and
# chip_smoke.py force each route through it.
FUSED_TRAIN_MIN_CODEBOOK_VOLUME = 0


def kernel_width(cfg: RqVaeConfig) -> bool:
    """Whether ``embed_dim`` fits the quantizer kernels (the port's route
    rule; JAX's Pallas kernels take any width). Both kernels apply a level's
    winner with a warp a row, D / 32 values a lane held in registers across
    the level loop (``csrc/rq_common.cuh``), so they take D <= ``MAX_D``
    (128) and raise above it. A wider embedding takes the plain per-level loop on
    both quantizer routes (training and ``encode_and_tokenize``): the same
    function, so the ids and values are JAX's up to near-ties and fp32
    rounding. It is a route, not a fallback: the kernels are never tried on
    such a width."""
    return cfg.embed_dim <= MAX_D


def _fused_train_quantize(params, cfg: RqVaeConfig, res: torch.Tensor) -> RqVaeOutput:
    """The hard estimators through one ``rq_quantize_train`` call for the
    whole residual loop; outputs cast back to the residual's dtype."""
    out = rq_quantize_train(res, effective_codebooks(params, cfg), cfg.codebook_mode.name,
                            cfg.commitment_weight)
    dt = res.dtype
    return RqVaeOutput(
        embeddings=out.embeddings.to(dt),
        residuals=out.residuals.to(dt),
        sem_ids=out.sem_ids,
        quantize_loss=out.quantize_loss.to(dt),
    )


def get_semantic_ids(params, cfg: RqVaeConfig, x: torch.Tensor, *, gumbel_t: float = 0.001,
                     training: bool = False,
                     generator: Optional[torch.Generator] = None) -> RqVaeOutput:
    """Encode then quantize through n_layers levels. The Gumbel estimator
    draws its noise from ``generator``, level by level."""
    res = encode(params, cfg, x)
    if (training
            and cfg.codebook_mode in (QuantizeForwardMode.STE, QuantizeForwardMode.ROTATION_TRICK)
            and cfg.codebook_size * cfg.embed_dim >= FUSED_TRAIN_MIN_CODEBOOK_VOLUME
            and kernel_width(cfg)
            and dispatch.kernels_enabled()
            and dispatch.model_axis_size() == 1):
        return _fused_train_quantize(params, cfg, res)
    embs, residuals, sem_ids = [], [], []
    q_loss = torch.zeros(res.shape[:-1], dtype=res.dtype, device=res.device)
    for level in range(cfg.n_layers):
        residuals.append(res)
        out = quantize.apply(params["layers"][level], res, temperature=gumbel_t,
                             training=training, generator=generator,
                             **_level_kwargs(cfg, level))
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


def _split_l2norm(x_hat: torch.Tensor, n_cat: int) -> torch.Tensor:
    """l2-normalize the dense slice, pass the categorical tail through. With
    n_cat == 0 the reference's slicing makes this a no-op, and so it is here."""
    if n_cat == 0:
        return x_hat
    return torch.cat([l2norm(x_hat[..., :-n_cat]), x_hat[..., -n_cat:]], dim=-1)


def forward(params, cfg: RqVaeConfig, x: torch.Tensor, *, gumbel_t: float,
            training: bool = False, generator: Optional[torch.Generator] = None) -> RqVaeLosses:
    """Full train / eval forward: losses and the batch statistics."""
    out = get_semantic_ids(params, cfg, x, gumbel_t=gumbel_t, training=training,
                           generator=generator)
    x_hat = decode(params, cfg, torch.sum(out.embeddings, dim=-1))
    x_hat = _split_l2norm(x_hat, cfg.n_cat_feats)

    # fp32 loss island under bf16 compute
    recon = categorical_reconstruction_loss(x_hat, x, cfg.n_cat_feats).float()
    loss = torch.mean(recon + out.quantize_loss.float())

    embs_norm = torch.linalg.vector_norm(out.embeddings.detach(), dim=1)  # (B, L)
    ids = out.sem_ids.detach()
    eq = torch.all(ids[:, None, :] == ids[None, :, :], dim=-1)  # (B, B)
    upper = torch.triu(eq, diagonal=1)  # duplicates strictly above the diagonal
    is_unique_row = torch.all(~upper, dim=1)
    p_unique = torch.sum(is_unique_row).float() / ids.shape[0]

    return RqVaeLosses(
        loss=loss,
        reconstruction_loss=torch.mean(recon),
        rqvae_loss=torch.mean(out.quantize_loss),
        embs_norm=embs_norm,
        p_unique_ids=p_unique,
    )


def _whole_params(name: str) -> None:
    if dispatch.model_axis_size() > 1:
        raise ValueError(f"{name} takes whole parameters: gather them "
                         "(parallel/mesh.gather_params) and call it under "
                         "dispatch.local_execution()")


def effective_codebooks(params, cfg: RqVaeConfig) -> torch.Tensor:
    """(L, K, D) stack of post-SimVQ / post-norm codebooks."""
    return torch.stack([
        quantize.effective_codebook(params["layers"][level],
                                    normalize=(level == 0 and cfg.codebook_normalize))
        for level in range(cfg.n_layers)
    ], dim=0)


def encode_and_tokenize(params, cfg: RqVaeConfig, x: torch.Tensor) -> torch.Tensor:
    """Hard-argmin tokenization: encoder MLP + the fused RQ kernel, in fp32.
    Same ids as ``get_semantic_ids(...).sem_ids`` up to near-ties (the kernel
    orders the distance terms as the TPU kernel does). An embedding wider
    than the kernel takes (``kernel_width``) is tokenized by
    ``get_semantic_ids``, as JAX does with Pallas disabled; so does every
    width when the kernel switch is off (``ops/dispatch``). Whole parameters
    only: under a tensor-parallel mesh it raises (gather them and call it
    under ``dispatch.local_execution``)."""
    _whole_params("encode_and_tokenize")
    if not kernel_width(cfg) or not dispatch.kernels_enabled():
        return get_semantic_ids(params, cfg, x).sem_ids
    z = encode(params, cfg, x).float().contiguous()
    cbs = effective_codebooks(params, cfg).float().contiguous()
    return rq_tokenize(z, cbs, commitment_weight=cfg.commitment_weight).sem_ids


def kmeans_prime(params, cfg: RqVaeConfig, x: torch.Tensor, generator: torch.Generator, *,
                 gumbel_t: float = 0.2) -> dict:
    """Sequential per-level k-means codebook init on a priming batch: level
    i's k-means runs on the residuals left after level i-1's training-mode
    forward (with its own k-means codebook). Returns new params; k-means and
    the Gumbel noise draw from ``generator`` in that order. Whole parameters
    only (see ``encode_and_tokenize``)."""
    _whole_params("kmeans_prime")
    with torch.no_grad():
        res = encode(params, cfg, x)
        layers = list(params["layers"])
        for level in range(cfg.n_layers):
            centroids = kmeans_lib.kmeans(res, cfg.codebook_size, generator=generator).centroids
            layers[level] = {**layers[level], "codebook": centroids.to(layers[level]["codebook"])}
            out = quantize.apply(layers[level], res, temperature=gumbel_t, training=True,
                                 generator=generator, **_level_kwargs(cfg, level))
            res = res - out.embeddings
    return {**params, "layers": layers}
