"""PyTorch/CUDA port of the shifted-scale post-training quantization
package ``shiftedscalequantization_tpu``.

Module paths mirror the JAX package. The port imports torch and numpy only;
its integer serving path runs hand-written Hopper kernels (``ops/cuda``).
Every entry point takes ``device`` (default ``"cuda"``) and raises when no
card is present unless ``device="cpu"`` is given.
"""

from . import fold_bn, graph, quantize
from .graph import BlockSpec, Flags, Graph, OpSpec, UnitQuant, UnitSpec, forward
from .ops import quant, wquant
from .quantize import QuantConfig, calibrate_acts, prepare_model

__version__ = "0.1.0"
