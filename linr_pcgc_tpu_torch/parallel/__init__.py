"""Multi-device training on torch.distributed: one process per rank
(``launch``), the rank's view of the mesh (``mesh``), the stage-parallel and
frame-parallel trainers (``train``) and GOP-parallel lanes
(``gop_parallel``).  Port of linr_pcgc_tpu/parallel/."""

from .gop_parallel import overfit_gops_parallel
from .mesh import Group, rank_devices, transport
from .train import (
    make_epoch_fn_dp,
    make_epoch_fn_sb_dp,
    make_epoch_fn_sb_sp,
    shard_gop,
    shard_sb_gop,
    train_parallel,
)
