"""The eval half of ``lvae_tpu/train``: weight conversion and the
per-image forward. Training itself comes in a later PR."""
