"""Bit packing and unpacking (mirror of ``compv_tpu/ops/bitops.py``).

Descriptors stay unpacked, (N, 256) {0,1} u8, where they feed the matcher,
and pack to (N, 32) u8 rows, LSB first, for the reference's 32-byte
descriptor layout (bit k of byte b is test 8*b + k).
"""
from __future__ import annotations

import torch

__all__ = ["pack_bits_to_bytes", "unpack_bytes_to_bits"]


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8*B) {0,1} -> (..., B) u8, LSB-first within each byte."""
    shape = bits.shape
    b = bits.reshape(*shape[:-1], shape[-1] // 8, 8).to(torch.uint8)
    return (b << _shifts(bits.device)).sum(dim=-1).to(torch.uint8)


def unpack_bytes_to_bits(bytes_arr: torch.Tensor) -> torch.Tensor:
    """(..., B) u8 -> (..., 8*B) {0,1} u8, LSB-first."""
    shape = bytes_arr.shape
    bits = (bytes_arr[..., None] >> _shifts(bytes_arr.device)) & 1
    return bits.reshape(*shape[:-1], shape[-1] * 8)
