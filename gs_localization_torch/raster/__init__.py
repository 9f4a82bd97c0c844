"""Differentiable tile rasterizer (stream layout).

1. ``preprocess``   per-Gaussian projection: frustum cull, EWA 2D covariance,
                    conic, tile rect, SH color.
2. ``binning``      depth-ranked, per-tile-culled, chunk-aligned pair stream.
3. ``stream_blend`` per-tile alpha compositing: hand-written CUDA kernels for
                    tensors on the card, plain PyTorch on the CPU.
4. ``rasterize``    public API gluing 1-3; ``pose_mode`` the localization
                    loop's per-pair projection.
"""

from .rasterize import RasterizerConfig, rasterize, render
