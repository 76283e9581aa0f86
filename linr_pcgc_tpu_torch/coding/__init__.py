from .container import pack_bitstream, unpack_bitstream
