"""The Ladder VAE's modules, eval mode (port of ``lvae_tpu/models``)."""
