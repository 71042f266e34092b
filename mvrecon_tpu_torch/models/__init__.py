"""models of the PyTorch port (counterpart of mvrecon_tpu/models)."""
