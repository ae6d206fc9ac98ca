"""sweeps layer of the PyTorch port (mirrors hydrolim_tpu.sweeps)."""
