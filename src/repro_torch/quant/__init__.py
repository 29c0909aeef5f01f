from repro_torch.quant.awq import (
    QuantizedLinear,
    dequantize,
    pack_int4,
    quantize_groupwise,
    unpack_int4,
)

__all__ = ["QuantizedLinear", "dequantize", "pack_int4", "quantize_groupwise", "unpack_int4"]
