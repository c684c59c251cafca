"""The 1-D IIns-VAE serving modules (encoders, Linear heads, IInsVAE)."""
