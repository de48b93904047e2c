"""Block reconstruction (PyTorch port of
``shiftedscalequantization_tpu/recon``): capture, the fused engine and the
sequential pipeline."""
from .capture import capture_io
from .engine import ReconSettings, reconstruct_node
from .pipeline import reconstruct_model
