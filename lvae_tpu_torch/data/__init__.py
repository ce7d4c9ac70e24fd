"""Dataset loading, preprocessing, the device-resident train split and
the host-fed ``--streaming`` loaders (the port of ``lvae_tpu/data``)."""
