"""Block reconstruction (PyTorch port of
``shiftedscalequantization_tpu/recon``): so far the quantizer plumbing of
the engine."""
