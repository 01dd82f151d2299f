"""RQ-VAE losses (counterpart of rqvae_tpu/models/losses.py).

* reconstruction: per-row squared L2 summed over the feature axis;
* categorical variant: adds BCE-with-logits over the trailing n_cat dims;
* quantize: ||sg(q) - v||^2 + beta * ||q - sg(v)||^2 (codebook + commitment),
  JAX's ``stop_gradient`` as ``.detach()`` at the same places.

All reductions are row-wise (no batch mean here); callers reduce.
"""
from __future__ import annotations

import torch


def reconstruction_loss(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sum((x_hat - x) ** 2, dim=-1)


def categorical_reconstruction_loss(x_hat: torch.Tensor, x: torch.Tensor,
                                    n_cat_feats: int) -> torch.Tensor:
    """Dense squared-L2 on the leading dims + BCE-with-logits on the cat tail."""
    if n_cat_feats <= 0:
        return reconstruction_loss(x_hat, x)
    dense = reconstruction_loss(x_hat[..., :-n_cat_feats], x[..., :-n_cat_feats])
    logits = x_hat[..., -n_cat_feats:]
    targets = x[..., -n_cat_feats:]
    bce = torch.maximum(logits, torch.zeros_like(logits)) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return dense + torch.sum(bce, dim=-1)


def quantize_loss(query: torch.Tensor, value: torch.Tensor,
                  commitment_weight: float = 0.25) -> torch.Tensor:
    """query = pre-quantization residual, value = quantized embedding."""
    emb_loss = torch.sum((query.detach() - value) ** 2, dim=-1)
    commit_loss = torch.sum((query - value.detach()) ** 2, dim=-1)
    return emb_loss + commitment_weight * commit_loss
