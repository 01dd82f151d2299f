"""The plain PyTorch reference the benchmark judges the port against.

It imports nothing of ``rqvae_tpu_torch`` and nothing of JAX: each helper it
needs is written here. ``model`` is the decoder, ``train`` a training step
(tokens, buckets, AdamW), ``corpus`` the tokenizer, dedup and prefix sets,
``search`` beam search and the score of a given tuple. It runs in float32
with TF32 off unless a control asks otherwise (``precision``).
"""
import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (``tf32``) or in full float32 inside the
    block; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
