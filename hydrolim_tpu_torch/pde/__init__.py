"""pde layer of the PyTorch port (mirrors hydrolim_tpu.pde)."""
