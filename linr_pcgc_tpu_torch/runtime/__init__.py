from .overfit import load_checkpoint, save_checkpoint
from .codec import decode_gop, encode_gop
