"""The IIns-VAE modules, 1-D and expanded 2-D (encoders, decoders, Linear heads, IInsVAE)."""
