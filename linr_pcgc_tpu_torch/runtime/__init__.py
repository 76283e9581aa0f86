from .overfit import (
    TrainConfig,
    adam_frame_update,
    adam_init,
    load_checkpoint,
    overfit_gop,
    save_checkpoint,
)
from .codec import decode_frame, decode_gop, encode_frame, encode_gop
