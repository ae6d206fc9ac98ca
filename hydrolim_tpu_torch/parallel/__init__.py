"""parallel layer of the PyTorch port (mirrors hydrolim_tpu.parallel)."""
