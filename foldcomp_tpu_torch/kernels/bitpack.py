"""FCZ record packing on int tensors.

Counterpart of foldcomp_tpu/kernels/bitpack.py `pack_records`: the 8-byte
BackboneChain bitfield (foldcomp.cpp:33-52), bit-equal to numpy
codec/fcz.py pack_records. The decode path unpacks records inside its
kernels, so `unpack_records` has no counterpart.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def pack_records(residue, phi, psi, omega, n_ca_c, ca_c_n, c_n_ca):
    """int field tensors [...] -> uint8 records [..., 8]; values wrap to
    their bitfield widths like C++ bitfield assignment."""
    residue = residue.to(I32) & 0x1F
    omega = omega.to(I32) & 0x7FF
    psi = psi.to(I32) & 0xFFF
    phi = phi.to(I32) & 0xFFF
    return torch.stack([
        (residue << 3) | (omega >> 8),
        omega & 0xFF,
        psi >> 4,
        ((psi & 0xF) << 4) | (phi >> 8),
        phi & 0xFF,
        ca_c_n.to(I32) & 0xFF,
        c_n_ca.to(I32) & 0xFF,
        n_ca_c.to(I32) & 0xFF,
    ], dim=-1).to(torch.uint8)
