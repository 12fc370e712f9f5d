"""Runnable entry points of the port (`python -m
software_rasterizer_tpu_torch.examples.<name>`)."""
