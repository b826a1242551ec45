"""Developer tools of the port, run as ``python -m edvr_tpu_torch.tools.<name>``."""
