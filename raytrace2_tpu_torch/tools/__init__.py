"""Command-line tools of the port (``python -m raytrace2_tpu_torch.tools.<name>``)."""
