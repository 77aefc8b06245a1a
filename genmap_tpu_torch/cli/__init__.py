"""genmap-tpu-torch command line."""
