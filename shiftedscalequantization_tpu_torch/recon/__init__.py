"""Block reconstruction (PyTorch port of
``shiftedscalequantization_tpu/recon``): capture (activations and the
Fisher gradients), the engine's modes and act phases, the sequential
pipeline, and the non-gradient selection searches (``search``)."""
from .capture import capture_grads, capture_io
from .engine import ReconSettings, reconstruct_act_delta, \
    reconstruct_act_shift, reconstruct_node
from .pipeline import reconstruct_model
