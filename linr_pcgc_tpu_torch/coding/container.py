"""Bitstream container: length-prefixed blob packing.

Wire format (identical to the reference's container so bitstream layouts are
reproducible; a copy of linr_pcgc_tpu/coding/container.py):

    uint32 count | uint32 length[count] | blob[0] .. blob[count-1]

little-endian, no alignment.
"""

from __future__ import annotations

import struct


def pack_bitstream(blobs: list[bytes]) -> bytes:
    for b in blobs:
        if len(b) >= 2**32 - 1:
            raise ValueError("blob too large for uint32 length prefix")
    header = struct.pack("<I", len(blobs)) + struct.pack(
        f"<{len(blobs)}I", *[len(b) for b in blobs]
    )
    return header + b"".join(bytes(b) for b in blobs)


def unpack_bitstream(data: bytes) -> list[bytes]:
    (count,) = struct.unpack_from("<I", data, 0)
    lengths = struct.unpack_from(f"<{count}I", data, 4)
    out = []
    pos = 4 + 4 * count
    for ln in lengths:
        out.append(data[pos: pos + ln])
        pos += ln
    return out
