"""Render + metrics pipeline: render a camera set from a trained map and
report PSNR / SSIM, plus LPIPS when its weights are given (``ops/lpips.py``,
loaded from user-supplied torch checkpoints), and optionally save the
renders as PNGs. Everything runs on the map's device.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.gaussians import GaussianParams
from ..data.scene import CameraInfo, load_image
from ..mapping.losses import psnr
from ..ops.lpips import LPIPS, convert_torch_weights_lpips
from ..ops.ssim import ssim
from ..raster import RasterizerConfig, rasterize


def load_lpips_params(vgg_path: str, lin_path: str,
                      device="cuda") -> LPIPS:
    """LPIPS from torch checkpoints on disk: ``vgg_path`` a torchvision
    ``vgg16`` (full model or features) state_dict, ``lin_path`` richzhang
    v0.1's ``vgg.pth`` lin-layer state_dict."""
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    if any(k.startswith("features.") for k in vgg_sd):
        vgg_sd = {k[len("features."):]: v for k, v in vgg_sd.items()
                  if k.startswith("features.")}
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    lin_sd = {k.replace("lin", "").replace("model.", ""): v
              for k, v in lin_sd.items()}
    return convert_torch_weights_lpips(
        {k: v.numpy() for k, v in vgg_sd.items()},
        {k: v.numpy() for k, v in lin_sd.items()}, device=device)


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


@torch.no_grad()
def render_and_eval(
    gaussians: GaussianParams,
    cameras: Sequence[CameraInfo],
    out_dir: Optional[str] = None,
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    image_loader: Optional[Callable] = None,
    bg: Optional[torch.Tensor] = None,
    log_fn: Callable[[str], None] = print,
    lpips_params: Optional[LPIPS] = None,
) -> Dict[str, float]:
    """Mean PSNR, SSIM (and LPIPS) over ``cameras`` whose loader returns a
    ground-truth image; renders go to ``out_dir/renders`` when given."""
    if image_loader is None:
        def image_loader(info):
            return load_image(info.image_path), None

    dev = gaussians.device
    psnrs: List[float] = []
    ssims: List[float] = []
    lpipss: List[float] = []
    if out_dir:
        os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
    for info in cameras:
        out = rasterize(gaussians, info.camera, raster_cfg, bg=bg)
        if out_dir:
            save_png(os.path.join(out_dir, "renders",
                                  os.path.basename(info.name) + ".png"),
                     out.color.cpu().numpy())
        gt, _ = image_loader(info)
        if gt is not None:
            gt = torch.tensor(np.asarray(gt, np.float32), device=dev)
            psnrs.append(float(psnr(out.color, gt)))
            ssims.append(float(ssim(out.color, gt)))
            if lpips_params is not None:
                lpipss.append(float(lpips_params(out.color, gt)))
    metrics = {}
    if psnrs:
        metrics = {"psnr": float(np.mean(psnrs)),
                   "ssim": float(np.mean(ssims))}
        if lpipss:
            metrics["lpips"] = float(np.mean(lpipss))
        log_fn(f"PSNR {metrics['psnr']:.2f}  SSIM {metrics['ssim']:.4f}"
               + (f"  LPIPS {metrics['lpips']:.4f}" if lpipss else "")
               + f" over {len(psnrs)} views")
    return metrics
