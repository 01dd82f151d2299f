"""The port's mirror of ``tests/test_e2e_ml32m.py``: fabricated raw ML-32M
csv files -> the port's offline preprocessing (stride-180 rolling windows)
-> registry load -> stage-1 and stage-2 smoke training on the CPU
(``device="cpu"``)."""
import numpy as np
import pytest

from rqvae_tpu_torch.data import movielens, registry
from rqvae_tpu_torch.data.text import hashed_stub_encoder
from rqvae_tpu_torch.utils.config import from_dict

pytestmark = pytest.mark.slow


@pytest.fixture
def ml32m_raw(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.RandomState(0)
    n_movies, n_users = 60, 40
    genres = ["Action", "Comedy", "Drama", "Horror"]
    with open(raw / "movies.csv", "w") as f:
        f.write("movieId,title,genres\n")
        for m in range(1, n_movies + 1):
            g = "|".join(rng.choice(genres, rng.randint(1, 3), replace=False))
            f.write(f'{m},"Movie {m} ({1990 + m % 30})",{g}\n')
    rows = []
    t = 1_000_000
    for u in range(1, n_users + 1):
        n = rng.randint(6, 15)
        for m in rng.randint(1, n_movies + 1, n):
            t += rng.randint(1, 50)
            rows.append((u, m, float(rng.choice([3.0, 3.5, 4.0, 5.0])), t))
    with open(raw / "ratings.csv", "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for r in rows:
            f.write(",".join(map(str, r)) + "\n")
    return tmp_path


def test_ml32m_process_load_and_train(ml32m_raw, tmp_path):
    movielens.process(str(ml32m_raw), "ml32m", max_seq_len=8,
                      encode_fn=hashed_stub_encoder(dim=16))
    bundle = registry.load(registry.RecDataset.ML_32M, str(ml32m_raw))
    n_items = len(bundle.items)
    assert n_items > 0
    feat_dim = bundle.items.x.shape[1]
    assert feat_dim > 16  # text embedding + genre one-hots
    # train at the TEXT width only: the model slices off the genre one-hots
    text_dim = 16
    assert bundle.train_seqs is not None and len(bundle.train_seqs) > 0
    assert bundle.eval_seqs is not None and len(bundle.eval_seqs) > 0
    # eval rows hold out the last item as the target
    assert (bundle.eval_seqs.item_ids_fut >= 0).all()
    # all ids index the item table
    assert bundle.train_seqs.item_ids.max() < n_items

    from rqvae_tpu_torch.train import train_decoder, train_rqvae

    rq_cfg = from_dict(train_rqvae.RqVaeTrainConfig, dict(
        iterations=30, batch_size=8, learning_rate=3e-3, dataset="ML_32M",
        dataset_folder=str(ml32m_raw), vae_input_dim=text_dim, vae_hidden_dims=(16,),
        vae_embed_dim=8, vae_codebook_size=8, vae_n_cat_feats=0, eval_every=30,
        save_model_every=30, save_dir_root=str(tmp_path / "rq"), log_every=10,
        kmeans_prime_items=n_items, eval_batches=1, seed=0))

    class Collect:
        records = []

        def log(self, step, metrics, force=False):
            self.records.append({"step": step, **metrics})

    train_rqvae.train(rq_cfg, logger=Collect(), device="cpu")
    losses = [float(r["total_loss"]) for r in Collect.records if "total_loss" in r]
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 1.5

    dec_cfg = from_dict(train_decoder.DecoderTrainConfig, dict(
        iterations=10, batch_size=8, dataset="ML_32M", dataset_folder=str(ml32m_raw),
        pretrained_rqvae_path=str(tmp_path / "rq"), vae_input_dim=text_dim,
        vae_hidden_dims=(16,), vae_embed_dim=8, vae_codebook_size=8, vae_n_cat_feats=0,
        decoder_embed_dim=16, attn_embed_dim=32, attn_heads=4, attn_layers=2,
        save_dir_root=str(tmp_path / "dec"), partial_eval_every=10, full_eval_every=10,
        eval_batches=1, generation_top_k=4, generation_candidates=8, log_every=5, seed=0))
    recs = []

    class C2:
        def log(self, step, metrics, force=False):
            recs.append(metrics)

    train_decoder.train(dec_cfg, logger=C2(), device="cpu")
    full = [r for r in recs if "h@10_slice_:4" in r]
    assert full, "ml32m decoder full eval must run"
    assert np.isfinite([float(r["total_loss"]) for r in recs if "total_loss" in r]).all()
