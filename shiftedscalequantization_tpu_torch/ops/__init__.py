from . import quant, wquant
