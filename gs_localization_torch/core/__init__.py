"""Core math: Gaussian parameters, cameras, SE(3), spherical harmonics."""

from .camera import Camera
from .gaussians import GaussianParams
from . import se3, sh
