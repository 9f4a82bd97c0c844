"""The work a render needs, counted from the benchmark's own plain walk,
and the published peaks of the chip it is held against.

This is the yardstick under every roofline and ``mfu`` metric: it counts
what the inputs need, not what the program issues, so that a program that
does the same work with fewer instructions reads higher.

Operations (a fused multiply-add counts 2, an exponential or a logarithm
counts 1, which understates it):

- blend forward, per (pixel, pair) reached before the pixel saturates: the
  conic's quadratic form and its exponential (10); per applied pair, the
  alpha clamp, the weight and the four accumulations of colour and depth
  and the transmittance update (13);
- blend backward, per applied pair: the alpha again (10) and the chain
  rule into the pair's ten screen quantities and the running sums (40);
- projection, per projected Gaussian: view transform, perspective divide,
  covariance R S S^T R^T, the Jacobian and the 2D covariance, its inverse
  (120 forward, 240 backward); spherical harmonics where they are evaluated
  (6 per coefficient and 12 for the basis, forward; twice that backward);
- per pixel, the loss's elementwise terms (10 forward, 10 backward) and,
  in training, SSIM's separable 11-tap blur of five maps per channel, each
  of the two passes 22 operations per value, forward and backward, and its
  20 elementwise operations per value forward and 40 backward. SSIM's
  dense banded matrix form is not counted.

Bytes: each input read once and each output written once. The blend reads
one 4-byte index per (Gaussian, tile) pair and ten 4-byte screen quantities
per Gaussian and writes five 4-byte values per pixel (colour, depth,
transmittance); its backward also reads the five per-pixel cotangents and
the final transmittance and writes ten gradients per Gaussian.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM5 data sheet: float32 outside the tensor cores, HBM3
PEAKS = {"H100": {"flops": 67e12, "bytes_per_s": 3.35e12}}


def peak(device_name: str) -> dict:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise KeyError(f"no published peak for {device_name!r}")


class Render(NamedTuple):
    """What one render of one view needs."""

    evaluated: int      # (pixel, pair) pairs reached before saturation
    applied: int        # of them, composited
    pairs: int          # (Gaussian, tile) pairs in the tile lists
    gaussians: int      # Gaussians projected (in some tile list)
    pixels: int

    def blend_fwd_flops(self) -> float:
        return 10.0 * self.evaluated + 13.0 * self.applied

    def blend_bwd_flops(self) -> float:
        return 50.0 * self.applied

    def blend_fwd_bytes(self) -> float:
        return 4.0 * self.pairs + 40.0 * self.gaussians + 20.0 * self.pixels

    def blend_bwd_bytes(self) -> float:
        return (4.0 * self.pairs + 80.0 * self.gaussians
                + 24.0 * self.pixels)

    def projection_flops(self, backward: bool) -> float:
        return (360.0 if backward else 120.0) * self.gaussians

    def sh_flops(self, degree: int, backward: bool) -> float:
        per = 6.0 * 3 * (degree + 1) ** 2 + 12.0
        return (3 if backward else 1) * per * self.gaussians

    def loss_flops(self) -> float:
        return 20.0 * 3 * self.pixels

    def ssim_flops(self) -> float:
        blur = 2 * 22.0 * 5 * 3 * self.pixels
        return 2 * blur + 60.0 * 3 * self.pixels


def min_seconds(flops: float, nbytes: float, p: dict):
    """The least time the chip needs, and what bounds it."""
    tf, tb = flops / p["flops"], nbytes / p["bytes_per_s"]
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def blend_seconds(r: Render, p: dict) -> float:
    """Least time of one blend forward and backward."""
    return (min_seconds(r.blend_fwd_flops(), r.blend_fwd_bytes(), p)[0]
            + min_seconds(r.blend_bwd_flops(), r.blend_bwd_bytes(), p)[0])


def tracking_iteration_flops(r: Render) -> float:
    """One refinement iteration in pose mode: projection forward and
    backward, blend forward and backward, the loss."""
    return (r.projection_flops(False) + r.projection_flops(True)
            + r.blend_fwd_flops() + r.blend_bwd_flops() + r.loss_flops())


def rebin_flops(r: Render, sh_degree: int) -> float:
    """A rebin: the projection and the colours at the binning view."""
    return r.projection_flops(False) + r.sh_flops(sh_degree, False)


def training_step_flops(r: Render, sh_degree: int) -> float:
    """One training step: projection and SH forward and backward, blend
    forward and backward, L1, depth and SSIM forward and backward."""
    return (r.projection_flops(False) + r.projection_flops(True)
            + r.sh_flops(sh_degree, False) + r.sh_flops(sh_degree, True)
            + r.blend_fwd_flops() + r.blend_bwd_flops() + r.loss_flops()
            + r.ssim_flops())


def count(blend_out, tiles, width: int, height: int) -> Render:
    """A ``Render`` from a plain blend (``reference.splat``) and its tiles."""
    return Render(int(blend_out.evaluated), int(blend_out.applied),
                  int(tiles.gauss.numel()),
                  int(tiles.gauss.unique().numel()), width * height)
