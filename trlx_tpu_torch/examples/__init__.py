"""Runnable examples of the port (``python -m trlx_tpu_torch.examples.<name>``)."""
