"""Text -> embedding encoding for item features (offline, host-side; the
port's own copy of rqvae_tpu/data/text.py).

The reference runs ``SentenceTransformer('sentence-transformers/sentence-t5-xl')``:
a T5 encoder, mean pooling, a 768-dim linear projection and L2
normalization. The same pipeline is built here from the plain HF
``transformers`` T5 encoder (``make_t5_pipeline_encoder``,
``sentence_t5_encoder``). ``hashed_stub_encoder`` is the download-free
stand-in; its vectors are byte-identical to the JAX package's for the same
texts and seed, so both packages' preprocessors write the same artifacts.

Every preprocessing entry point takes an ``encode_fn``, so tests and runs
without network substitute the stub. ``torch``, ``transformers`` and
``huggingface_hub`` are imported inside the functions that need them.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

EncodeFn = Callable[[List[str]], np.ndarray]


def hashed_stub_encoder(dim: int = 768, seed: int = 0) -> EncodeFn:
    """Deterministic stand-in: a per-text seeded Gaussian, L2-normalized.
    Distinct texts give near-orthogonal vectors, identical texts identical
    vectors. The per-text seed is sha256-derived, so the vectors do not
    depend on ``PYTHONHASHSEED`` or on the host."""

    def encode(texts: List[str]) -> np.ndarray:
        import hashlib

        out = np.empty((len(texts), dim), np.float32)
        for i, t in enumerate(texts):
            h = int.from_bytes(
                hashlib.sha256(f"{seed}:{t}".encode()).digest()[:4], "little"
            ) & 0x7FFFFFFF
            v = np.random.RandomState(h).randn(dim).astype(np.float32)
            out[i] = v / (np.linalg.norm(v) + 1e-12)
        return out

    return encode


def make_t5_pipeline_encoder(
    tok, enc, dense_w=None, *, batch_size: int = 32, device=None,
    max_length: int = 256,
) -> EncodeFn:
    """The sentence-t5 pipeline from given components: T5 encoder ->
    attention-masked mean pooling -> optional dense head -> L2 norm.
    ``enc`` (and ``dense_w``) must already sit on ``device``: the GPU unless
    the caller says ``"cpu"``."""
    import torch

    from rqvae_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)

    @torch.no_grad()
    def encode(texts: List[str]) -> np.ndarray:
        chunks = []
        for i in range(0, len(texts), batch_size):
            batch = tok(texts[i:i + batch_size], padding=True, truncation=True,
                        max_length=max_length, return_tensors="pt")
            batch = {k: v.to(dev) for k, v in dict(batch).items()}
            h = enc(**batch).last_hidden_state                 # (B, T, D)
            m = batch["attention_mask"][..., None].to(h.dtype)
            pooled = (h * m).sum(1) / m.sum(1).clamp(min=1e-9)
            if dense_w is not None:
                pooled = pooled @ dense_w.T
            pooled = torch.nn.functional.normalize(pooled, dim=-1)
            chunks.append(pooled.float().cpu().numpy())
        return np.concatenate(chunks, axis=0)

    return encode


def sentence_t5_encoder(
    model_name: str = "sentence-transformers/sentence-t5-xl",
    batch_size: int = 32,
    device: Optional[str] = None,
) -> EncodeFn:
    """T5 encoder + mean pooling + dense projection + L2 norm (the
    sentence-t5 recipe) on ``device`` (the GPU unless told otherwise).
    Needs the model's weights (a download or a local cache)."""
    from transformers import AutoTokenizer, T5EncoderModel

    from rqvae_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tok = AutoTokenizer.from_pretrained(model_name)
    enc = T5EncoderModel.from_pretrained(model_name).to(dev).eval()

    # sentence-t5 ships a linear 2_Dense head (d_model -> 768); load it when
    # the repo has one, else keep the mean-pooled encoder states
    dense_w = None
    try:
        from huggingface_hub import hf_hub_download
        import safetensors.torch as st

        path = hf_hub_download(model_name, "2_Dense/model.safetensors")
        dense_w = st.load_file(path)["linear.weight"].to(dev)
    except (ImportError, OSError, KeyError, ValueError):   # no head, no hub, no safetensors
        pass
    return make_t5_pipeline_encoder(tok, enc, dense_w, batch_size=batch_size, device=dev)
