"""Real spherical harmonics (degree 0..3) color evaluation.

3DGS convention: result = sum of SH terms + 0.5, clamped at 0. Band order
[1, y, z, x, xy, yz, 2z^2-x^2-y^2, xz, x^2-y^2, ...].
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., K, 3) coefficients along (..., 3) unit dirs -> (..., 3) RGB,
    without the +0.5 offset and clamp (see ``sh_to_clamped_rgb``)."""
    result = SH_C0 * sh[..., 0, :]
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * sh[..., 1, :]
            + SH_C1 * z * sh[..., 2, :]
            - SH_C1 * x * sh[..., 3, :]
        )
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4, :]
                + SH_C2[1] * yz * sh[..., 5, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + SH_C2[3] * xz * sh[..., 7, :]
                + SH_C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if degree > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
    return result


def sh_to_clamped_rgb(sh: torch.Tensor, dirs: torch.Tensor,
                      degree: int) -> torch.Tensor:
    """SH -> RGB with the 3DGS +0.5 offset and clamp-at-zero."""
    return torch.clamp_min(eval_sh(sh, dirs, degree) + 0.5, 0.0)


def rgb_to_sh_dc(rgb):
    """Invert the DC band: rgb = C0 * dc + 0.5 (tensor or numpy array)."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(dc):
    return SH_C0 * dc + 0.5
