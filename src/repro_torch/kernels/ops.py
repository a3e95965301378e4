"""Public kernel ops of the port (counterpart of `repro/kernels/ops.py`).

Same positional signatures as the reference's ops, plus `ralt_record_`
(the tracker's whole record in one launch, which the reference leaves to
XLA around its kernel) and `decode_attention_int8_append` (the int8 KV
cache's quantize, write and attention in one launch, which the reference
computes in its attention block); the TPU tiling arguments (`block_s`, `block_n`,
`block_q`, `block_k`, `interpret`) have no counterpart.  Each op
dispatches on its tensors' device: CUDA launches the hand-written kernel
(or raises), CPU runs the plain PyTorch version.  `LAUNCHES` holds one
plain-integer launch count per op.
"""
from __future__ import annotations

from ._build import LAUNCHES, reset_launches  # noqa: F401
from .decode_attention import (decode_attention,  # noqa: F401
                               decode_attention_head_major,
                               decode_attention_int8_append)
from .flash_attention import flash_attention, flash_attention_fwd  # noqa: F401
from .ralt_score import ralt_record_, ralt_update  # noqa: F401
from .ssd_scan import ssd_scan, ssd_scan_fwd  # noqa: F401
