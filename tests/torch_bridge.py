"""Carry JAX-package objects over to the PyTorch port through numpy (CPU)."""

import numpy as np
import torch

from gs_localization_torch.core.camera import Camera as TCamera
from gs_localization_torch.core.gaussians import FIELDS
from gs_localization_torch.core.gaussians import GaussianParams as TGaussians
from gs_localization_torch.raster.preprocess import Preprocessed as TPrep


def gaussians_to_torch(g) -> TGaussians:
    return TGaussians.from_numpy({f: np.asarray(getattr(g, f)) for f in FIELDS},
                                 g.sh_degree, g.max_sh_degree, device="cpu")


def camera_to_torch(cam) -> TCamera:
    return TCamera.from_numpy(
        np.asarray(cam.w2c), np.asarray(cam.fx), np.asarray(cam.fy),
        np.asarray(cam.cx), np.asarray(cam.cy), cam.width, cam.height,
        cam.znear, cam.zfar, device="cpu")


def prep_to_torch(prep) -> TPrep:
    return TPrep(*[torch.tensor(np.asarray(a)) for a in prep])


def np_of(x) -> np.ndarray:
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
