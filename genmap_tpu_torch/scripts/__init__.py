"""Entry points run as `python -m genmap_tpu_torch.scripts.<name>`."""
