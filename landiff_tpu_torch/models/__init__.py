"""Stage-2 models of the port: DiT, VQ, TiTok decoder, semantic
conditioner, VAE decoder and T5 encoder."""
