from .overfit import (
    GopBatch,
    TrainConfig,
    adam_frame_update,
    adam_init,
    assemble_gop,
    load_checkpoint,
    make_epoch_fn,
    overfit_gop,
    save_checkpoint,
)
from .codec import decode_frame, decode_gop, encode_frame, encode_gop
