from .ply import read_ply, write_ply_ascii, write_ply_binary
from .synthetic import smooth_shell, smooth_shell_sequence, synthetic_cloud
from .dataset import (
    FramePyramid,
    LevelData,
    PyramidDataset,
    build_pyramid,
    bucket_size,
)
