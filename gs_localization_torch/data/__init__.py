"""Data I/O: Gaussian map PLY files, COLMAP models, scenes held in memory."""

from .ply import load_gaussian_ply, save_gaussian_ply
from .colmap import (
    ColmapCamera, ColmapImage, ColmapPoint3D,
    read_colmap_model, write_colmap_model_text,
)
from .scene import SceneInfo, load_colmap_scene, compute_scene_extent
