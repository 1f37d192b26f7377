"""Bit packing, unpacking, popcount and the logical ops (mirror of
``compv_tpu/ops/bitops.py``; reference base/compv_bits.cxx).

Descriptors stay unpacked, (N, 256) {0,1} u8, where they feed the matcher,
and pack to (N, 32) u8 rows, LSB first, for the reference's 32-byte
descriptor layout (bit k of byte b is test 8*b + k).
"""
from __future__ import annotations

import torch

__all__ = ["pack_bits_to_bytes", "unpack_bytes_to_bits", "popcount_bytes",
           "bits_and", "bits_or", "bits_xor", "bits_not"]


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


def popcount_bytes(bytes_arr: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of packed bytes: (..., B) u8 -> (...,) i32."""
    return unpack_bytes_to_bits(bytes_arr).sum(dim=-1, dtype=torch.int32)


def bits_and(a, b):
    return torch.bitwise_and(a, b)


def bits_or(a, b):
    return torch.bitwise_or(a, b)


def bits_xor(a, b):
    return torch.bitwise_xor(a, b)


def bits_not(a):
    return torch.bitwise_not(a)
