"""Hand-written Hopper kernels, their plain PyTorch versions and the
dispatch seam the model routes through (``dispatch.py``)."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import tt_linear as _tl

KERNELS = ("tt_linear", "tt_linear_batched_a", "flash_attention",
           "decode_attention", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "paged_decode_attention", "tt_linear_w8", "tt_linear_batched_a_w8",
           "paged_decode_attention_int8", "tt_linear_f32",
           "flash_attention_f32", "flash_attention_fwd_f32",
           "flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32",
           "tt_linear_batched_a_f32", "decode_attention_f32",
           "paged_decode_attention_f32", "paged_decode_attention_int8_f32",
           "flash_attention_d256", "flash_attention_fwd_d256",
           "decode_attention_d256", "paged_decode_attention_d256",
           "paged_decode_attention_int8_d256", "tt_linear_w8_f32",
           "tt_linear_batched_a_w8_f32", "flash_attention_bwd_dq_d256",
           "flash_attention_bwd_dkv_d256", "flash_attention_d112",
           "flash_attention_fwd_d112", "decode_attention_d112",
           "paged_decode_attention_d112", "paged_decode_attention_int8_d112",
           "flash_attention_bwd_dq_d112", "flash_attention_bwd_dkv_d112")
_COUNTERS = (_tl.LAUNCHES, _fa.LAUNCHES, _pa.LAUNCHES)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {k: v for d in _COUNTERS for k, v in d.items()}


def reset_launch_counts() -> None:
    for d in _COUNTERS:
        for k in d:
            d[k] = 0
