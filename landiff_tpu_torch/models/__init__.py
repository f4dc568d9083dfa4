"""Models of the port: DiT, VQ with Theia and the TiTok encoder /
decoder, semantic conditioner, VAE encoder / decoder, T5 encoder and the
stage-1 GPT / LM."""
