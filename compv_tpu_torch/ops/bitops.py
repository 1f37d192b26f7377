"""Bit packing, unpacking, popcount and the logical ops (mirror of
``compv_tpu/ops/bitops.py``; reference base/compv_bits.cxx).

Descriptors stay unpacked, (N, 256) {0,1} u8, where they feed the matcher,
and pack to (N, 32) u8 rows, LSB first, for the reference's 32-byte
descriptor layout (bit k of byte b is test 8*b + k).

The reference takes any integer dtype and keeps it (``jnp``'s promotion
against its uint8 shifts). PyTorch has few kernels for uint16 and uint32,
on the CPU or the card, so those two run in int64 and are cast back.
"""
from __future__ import annotations

import torch

__all__ = ["pack_bits_to_bytes", "unpack_bytes_to_bits", "popcount_bytes",
           "bits_and", "bits_or", "bits_xor", "bits_not"]


_WIDE = (torch.uint16, torch.uint32)


def _shifts(device, dtype=torch.uint8) -> torch.Tensor:
    return torch.arange(8, dtype=dtype, device=device)


def pack_bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8*B) {0,1} -> (..., B) u8, LSB-first within each byte."""
    shape = bits.shape
    b = bits.reshape(*shape[:-1], shape[-1] // 8, 8).to(torch.uint8)
    return (b << _shifts(bits.device)).sum(dim=-1).to(torch.uint8)


def unpack_bytes_to_bits(bytes_arr: torch.Tensor) -> torch.Tensor:
    """(..., B) u8 -> (..., 8*B) {0,1} u8, LSB-first."""
    shape = bytes_arr.shape
    if bytes_arr.dtype in _WIDE:
        wide = bytes_arr.to(torch.int64)[..., None]
        bits = ((wide >> _shifts(bytes_arr.device, torch.int64)) & 1
                ).to(bytes_arr.dtype)
    else:
        bits = (bytes_arr[..., None] >> _shifts(bytes_arr.device)) & 1
    return bits.reshape(*shape[:-1], shape[-1] * 8)


def popcount_bytes(bytes_arr: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of packed bytes: (..., B) u8 -> (...,) i32."""
    return unpack_bytes_to_bits(bytes_arr).sum(dim=-1, dtype=torch.int32)


def _bitwise(op, a, *rest):
    if a.dtype in _WIDE:
        out = op(a.to(torch.int64), *[b.to(torch.int64) for b in rest])
        return (out & (1 << torch.iinfo(a.dtype).bits) - 1).to(a.dtype)
    return op(a, *rest)


def bits_and(a, b):
    return _bitwise(torch.bitwise_and, a, b)


def bits_or(a, b):
    return _bitwise(torch.bitwise_or, a, b)


def bits_xor(a, b):
    return _bitwise(torch.bitwise_xor, a, b)


def bits_not(a):
    return _bitwise(torch.bitwise_not, a)
