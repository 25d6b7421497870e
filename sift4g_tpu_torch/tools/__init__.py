"""Measurement tools of the port (``python -m sift4g_tpu_torch.tools.<tool>``)."""
