from .ac import (
    binary_decode,
    binary_decode_batch,
    binary_encode,
    binary_encode_batch,
    binary_estimate_bits,
    shared_cdf_decode,
    shared_cdf_encode,
)
from .container import pack_bitstream, unpack_bitstream
