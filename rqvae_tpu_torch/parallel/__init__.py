from rqvae_tpu_torch.parallel import mesh  # noqa: F401
