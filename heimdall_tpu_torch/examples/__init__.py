"""Runnable demos of the port, run as
``python -m heimdall_tpu_torch.examples.<name>`` (counterparts of the
repository's examples/); importing them runs nothing."""
