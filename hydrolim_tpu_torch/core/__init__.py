"""core layer of the PyTorch port (mirrors hydrolim_tpu.core)."""
