"""Dataset loading, preprocessing and the device-resident train split (a
subset of ``lvae_tpu/data``: the flagship's Bernoulli datasets)."""
