"""Block reconstruction (PyTorch port of
``shiftedscalequantization_tpu/recon``): capture, the engine's modes and
act-delta phase, and the sequential pipeline."""
from .capture import capture_io
from .engine import ReconSettings, reconstruct_act_delta, reconstruct_node
from .pipeline import reconstruct_model
