"""Differentiable tile rasterizer.

1. ``preprocess``   per-Gaussian projection: frustum cull, EWA 2D covariance,
                    conic, tile rect, SH color.
2. ``binning``      depth-ranked, per-tile-culled pairs: a chunk-aligned pair
                    stream or a (tiles, max_per_tile) id matrix.
3. ``stream_blend`` / ``pallas_blend``  per-tile alpha compositing over the
                    stream or over pregathered windows: hand-written CUDA
                    kernels for tensors on the card, plain PyTorch on the CPU.
4. ``rasterize``    public API gluing 1-3; ``pose_mode`` the localization
                    loop's per-pair projection.
"""

from .rasterize import RasterizerConfig, rasterize, render
