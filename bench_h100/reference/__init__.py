"""Plain PyTorch references of the benchmark's configurations, one file a
configuration, with what they share in nls.py. They import nothing of
stnls_tpu_torch, of JAX or of the JAX package."""
