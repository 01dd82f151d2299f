"""Time of the port's span attention kernels against the tiles they compute,
at the packed ML-32M shape (B = 96 rows, H = 8, N = 808, Dh = 64, bf16), on
one GPU, beside the flat flash kernels on the same operands.

The span kernels skip every (query tile, key tile) pair in which no row may
attend any key, so their time should follow the share of 64 x 64 tiles that
hold an allowed pair. Span layouts: every tile skipped (lo = hi = 0), every
tile needed (every row attends all keys), one 64-key diagonal block per
query tile, and the packed layout of ``chip_smoke.py``'s phase 16 (the
first steady-state ``SequencePacker`` batch over 4,096 full 200-item
histories, through ``retrieval.packed_spans``). Prints one JSON line per
layout: the share of allowed pairs and of computed tiles, and the CUDA-event
ms per call of the forward and the backward. Run from a checkout's root:
``python3 experiments/torch_span_tiles.py``.
"""
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from rqvae_tpu_torch.data import packing  # noqa: E402
from rqvae_tpu_torch.data.dataset import SeqDataset  # noqa: E402
from rqvae_tpu_torch.models import retrieval  # noqa: E402
from rqvae_tpu_torch.ops import _cuda_build  # noqa: E402
from rqvae_tpu_torch.ops import flash_attention as fa  # noqa: E402
from rqvae_tpu_torch.tokenizer import semids  # noqa: E402

B, H, DH, SLOTS, ITEMS = 96, 8, 64, 8, 200
N = SLOTS + 4 * ITEMS


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def packed_spans(dev):
    """Encoder spans of the first steady-state packed batch (chip_smoke's
    phase 16 draws its data the same way)."""
    rng = np.random.RandomState(0)
    seqs = SeqDataset(user_ids=np.arange(4096, dtype=np.int32),
                      item_ids=rng.randint(0, 84432, (4096, ITEMS)).astype(np.int32),
                      item_ids_fut=rng.randint(0, 84432, (4096, 1)).astype(np.int32),
                      max_seq_len=ITEMS)
    packer = packing.SequencePacker(seqs=seqs, rng=np.random.default_rng(0), rows=B, slots=SLOTS)
    for _ in range(3):
        packer.next_batch()
    batch = packing.to_device(packer.next_batch()[0], dev)
    index = semids.build_index(torch.zeros((84432, 4), dtype=torch.int32, device=dev), 256)
    cfg = retrieval.RetrievalConfig(sem_id_dim=4)
    return retrieval.packed_spans(cfg, semids.tokenize_packed(index, batch))[0]


def main() -> int:
    _cuda_build.build_all(["flash_attention_fwd", "flash_attention_bwd",
                           "flash_attention_spans_fwd", "flash_attention_spans_bwd"])
    dev = torch.device("cuda")
    g0 = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(B, N, 3 * H * DH, device=dev, generator=g0).bfloat16()
    q, k, v = (t.reshape(B, N, H, DH).transpose(1, 2) for t in qkv.chunk(3, -1))
    g = torch.randn(B, H, N, DH, device=dev, generator=g0).bfloat16()

    fo, fm, finv = fa.flash_attention_fwd(q, k, v)
    print(json.dumps({"layout": "flat (no mask)", "fwd_ms": cuda_ms(lambda: fa.flash_attention_fwd(
        q, k, v), 20), "bwd_ms": cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, g, fm, finv), 10)}))
    zeros = torch.zeros((B, N), dtype=torch.int32, device=dev)
    rows = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    layouts = {
        "all tiles skipped": (zeros, zeros, zeros - 1),
        "all tiles needed": (zeros, zeros + N, zeros - 1),
        "diagonal 64-key blocks": (rows // 64 * 64, rows // 64 * 64 + 64, zeros - 1),
        "packed (phase 16, batch 0)": packed_spans(dev),
    }
    nt = (N + 63) // 64
    for name, spans in layouts.items():
        allow = fa.span_mask(spans, N)
        padded = torch.zeros((B, nt * 64, nt * 64), dtype=torch.bool, device=dev)
        padded[:, :N, :N] = allow
        tiles = padded.reshape(B, nt, 64, nt, 64).any(4).any(2)
        out, m, inv = fa.flash_attention_spans_fwd(q, k, v, *spans)
        print(json.dumps({
            "layout": name, "allowed_pair_share": float(allow.float().mean()),
            "computed_tile_share": float(tiles.float().mean()),
            "fwd_ms": cuda_ms(lambda: fa.flash_attention_spans_fwd(q, k, v, *spans), 20),
            "bwd_ms": cuda_ms(lambda: fa.flash_attention_spans_bwd(q, k, v, *spans, g, m, inv), 10),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
