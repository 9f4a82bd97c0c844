"""Plain map training steps (3DGS's optimisation, as LoGS trains its maps).

``init_from_points``: a Gaussian per point, isotropic log scale from the
mean squared distance to its three nearest other points (clamped at 1e-7),
identity rotation, opacity 0.1, DC colour from the point colour, higher SH
bands zero, active SH degree 0.

``train_step``: render the view, loss = (1 - l_ssim) L1 + l_ssim (1 - SSIM)
+ l_depth * mean |D m - D_gt m| (m: the view's depth > 0), SSIM with an
11-tap Gaussian window of sigma 1.5, zero padding, C1 = 0.01^2, C2 =
0.03^2; then one Adam step per parameter group (b1 0.9, b2 0.999, eps 1e-15
outside the square root, bias correction after the count's increment) at
the published learning rates, the position's decaying exponentially from
1.6e-4 to 1.6e-6 times the scene extent over 30,000 steps (read before the
count's increment).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from . import splat

GROUPS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def knn_mean_sq(points: torch.Tensor, k: int = 3,
                block: int = 1024) -> torch.Tensor:
    """Mean of the k smallest squared distances to other points."""
    out = torch.empty(points.shape[0], dtype=points.dtype,
                      device=points.device)
    sq = torch.sum(points * points, 1)
    for lo in range(0, points.shape[0], block):
        hi = min(points.shape[0], lo + block)
        d2 = torch.clamp_min(sq[lo:hi, None] + sq[None, :]
                             - 2 * points[lo:hi] @ points.T, 0)
        d2[torch.arange(hi - lo), torch.arange(lo, hi)] = float("inf")
        out[lo:hi] = torch.topk(d2, k, 1, largest=False).values.mean(1)
    return out


def init_from_points(points: torch.Tensor, colors: torch.Tensor,
                     max_sh_degree: int) -> Dict[str, torch.Tensor]:
    n = points.shape[0]
    k = (max_sh_degree + 1) ** 2
    d = torch.clamp_min(knn_mean_sq(points), 1e-7)
    quat = torch.zeros((n, 4), dtype=points.dtype, device=points.device)
    quat[:, 0] = 1
    return {
        "xyz": points.clone(),
        "features_dc": ((colors - 0.5) / splat.SH_C0)[:, None, :],
        "features_rest": torch.zeros((n, k - 1, 3), dtype=points.dtype,
                                     device=points.device),
        "scaling": torch.log(torch.sqrt(d))[:, None].repeat(1, 3),
        "rotation": quat,
        "opacity": torch.full((n, 1), math.log(0.1 / 0.9),
                              dtype=points.dtype, device=points.device),
    }


def _window(dtype, device):
    x = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-x * x / (2 * 1.5**2))
    return (g / g.sum()).to(dtype=dtype, device=device)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images."""
    w = _window(a.dtype, a.device)

    def blur(x):                               # (C, H, W), zero padded
        x = F.conv2d(x[:, None], w.view(1, 1, 11, 1), padding=(5, 0))
        return F.conv2d(x, w.view(1, 1, 1, 11), padding=(0, 5))[:, 0]

    a, b = a.permute(2, 0, 1), b.permute(2, 0, 1)
    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    return torch.mean((2 * mu1 * mu2 + c1) * (2 * s12 + c2)
                      / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)))


def training_loss(color, depth, gt, gt_depth, cfg):
    loss = (1 - cfg["lambda_dssim"]) * torch.mean(torch.abs(color - gt)) \
        + cfg["lambda_dssim"] * (1 - ssim(color, gt))
    if gt_depth is not None and cfg["lambda_gt_depth"]:
        m = (gt_depth > 0).to(depth.dtype)
        loss = loss + cfg["lambda_gt_depth"] * torch.mean(
            torch.abs(depth * m - gt_depth * m))
    return loss


def group_lr(cfg: dict, name: str, count: int) -> float:
    if name == "xyz":
        t = min(max(count / cfg["position_lr_max_steps"], 0.0), 1.0)
        lo = cfg["position_lr_init"] * cfg["spatial_scale"]
        hi = cfg["position_lr_final"] * cfg["spatial_scale"]
        return math.exp(math.log(lo) * (1 - t) + math.log(hi) * t)
    return {"features_dc": cfg["feature_lr"],
            "features_rest": cfg["feature_lr"] / 20,
            "scaling": cfg["scaling_lr"], "rotation": cfg["rotation_lr"],
            "opacity": cfg["opacity_lr"]}[name]


class Step(NamedTuple):
    loss: float
    grads: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]      # after the step


def train_steps(params: Dict[str, torch.Tensor], views: List[tuple],
                sh_degree: int, cfg: dict) -> List[Step]:
    """One Adam step per view ``(cam, gt, gt_depth)`` from ``params``."""
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = []
    for count, (cam, gt, gt_depth) in enumerate(views):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        m = splat.Map(leaves["xyz"], leaves["scaling"], leaves["rotation"],
                      leaves["opacity"][:, 0],
                      torch.cat([leaves["features_dc"],
                                 leaves["features_rest"]], 1), sh_degree)
        with torch.enable_grad():
            scr = splat.project(m, cam)
            tiles = splat.bin_tiles(scr, cam)
            loss, _ = splat.render_with_grad(
                scr.table, tiles, cam,
                lambda c, d, a: training_loss(c, d, gt, gt_depth, cfg))
        grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad)
                 for k, v in leaves.items()}
        new = {}
        with torch.no_grad():
            t = count + 1
            for k in GROUPS:
                g = grads[k]
                mu[k] = 0.1 * g + 0.9 * mu[k]
                nu[k] = 0.001 * g * g + 0.999 * nu[k]
                upd = (mu[k] / (1 - 0.9**t)) / (
                    torch.sqrt(nu[k] / (1 - 0.999**t)) + 1e-15)
                new[k] = params[k] - group_lr(cfg, k, count) * upd
        out.append(Step(float(loss), grads, new))
        params = new
    return out
