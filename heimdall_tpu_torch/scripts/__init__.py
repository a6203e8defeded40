"""Profilers of the port, run as ``python -m heimdall_tpu_torch.scripts.<name>``
(counterparts of the JAX package's scripts/); importing them runs nothing."""
