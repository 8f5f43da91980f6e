"""Optimizers (``repro.optim``'s counterpart): AdamW and int8 gradient
compression."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compress import (compressed_psum, dequantize_int8,
                                        quantize_int8)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "compressed_psum", "quantize_int8", "dequantize_int8"]
