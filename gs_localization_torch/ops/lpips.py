"""LPIPS (Learned Perceptual Image Patch Similarity), VGG16 variant.

The reference's ``lpipsPyTorch`` (richzhang v0.1 design), as the JAX
package's ``ops/lpips.py`` computes it: a frozen VGG16 feature stack tapped
after relu1_2/relu2_2/relu3_3/relu4_3/relu5_3, channel-unit-normalized
activations, squared differences weighted by 1x1 "lin" heads, averaged
over space and summed across taps. Images are (H, W, 3) in [0, 1], shifted
and scaled by (-.030,-.088,-.188)/(.458,.448,.450) as given, as the
reference does.

The convolutions are ``F.conv2d`` calls (a library convolution: this is a
metric outside any blend kernel). Weights are not bundled:
``convert_torch_weights_lpips`` maps torchvision's ``vgg16().features``
state_dict plus richzhang's ``vgg.pth`` lin weights onto the module, and
``lpips_from_jax_params`` carries the JAX package's params (numpy) over.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

# torchvision vgg16.features layout: 'C' = 3x3 conv (+ReLU), 'P' = 2x2
# maxpool.
VGG16_LAYOUT: Sequence = (
    ("C", 64), ("C", 64), ("P",),
    ("C", 128), ("C", 128), ("P",),
    ("C", 256), ("C", 256), ("C", 256), ("P",),
    ("C", 512), ("C", 512), ("C", 512), ("P",),
    ("C", 512), ("C", 512), ("C", 512),
)
# taps after the ReLU of these conv indices (0-based over the conv list):
# conv1_2, conv2_2, conv3_3, conv4_3, conv5_3
VGG16_TAPS = (1, 3, 6, 9, 12)
VGG16_TAP_CHANNELS = (64, 128, 256, 512, 512)
# torchvision features-module indices of the 13 convs
_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """LPIPS distance between two (H, W, 3) images in [0, 1] -> () tensor.

    ``weights``/``biases``: the 13 convs in torch layout (out, in, 3, 3);
    ``lin``: per tap, the (C_tap,) non-negative head weights."""

    def __init__(self, weights: List[np.ndarray], biases: List[np.ndarray],
                 lin: List[np.ndarray], device="cuda"):
        super().__init__()
        dev = resolve_device(device)

        def param(a):
            return nn.Parameter(torch.tensor(np.asarray(a, np.float32),
                                             device=dev),
                                requires_grad=False)

        self.weights = nn.ParameterList([param(w) for w in weights])
        self.biases = nn.ParameterList([param(b) for b in biases])
        self.lin = nn.ParameterList([param(w) for w in lin])
        shape = dict(dtype=torch.float32, device=dev)
        self.register_buffer("shift", torch.tensor(_SHIFT, **shape))
        self.register_buffer("scale", torch.tensor(_SCALE, **shape))

    def features(self, image: torch.Tensor) -> List[torch.Tensor]:
        """Unit-normalized tap activations (1, C, h, w) of one image."""
        x = ((image - self.shift) / self.scale).permute(2, 0, 1)[None]
        taps, conv_i = [], 0
        for entry in VGG16_LAYOUT:
            if entry[0] == "P":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(F.conv2d(x, self.weights[conv_i], self.biases[conv_i],
                                padding=1))
            if conv_i in VGG16_TAPS:
                norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
                taps.append(x / (norm + 1e-10))
            conv_i += 1
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for tx, ty, w in zip(self.features(x), self.features(y), self.lin):
            d = (tx - ty) ** 2
            total = total + torch.mean(torch.sum(d * w[None, :, None, None],
                                                 dim=1))
        return total


def convert_torch_weights_lpips(vgg_features_sd: Dict[str, Any],
                                lin_sd: Dict[str, Any],
                                device="cuda") -> LPIPS:
    """torchvision ``vgg16().features.state_dict()`` + richzhang lin weights
    (keys ``0.1.weight``..``4.1.weight``, ``lin0.model.1.weight`` or
    ``lin0.1.weight``) -> ``LPIPS`` on ``device``."""
    weights = [np.asarray(vgg_features_sd[f"{i}.weight"]) for i in _CONV_IDX]
    biases = [np.asarray(vgg_features_sd[f"{i}.bias"]) for i in _CONV_IDX]
    lin = []
    for t in range(5):
        for key in (f"{t}.1.weight", f"lin{t}.model.1.weight",
                    f"lin{t}.1.weight"):
            if key in lin_sd:
                lin.append(np.asarray(lin_sd[key]).reshape(-1))  # (1,C,1,1)
                break
        else:
            raise KeyError(f"missing lin weight for tap {t}")
    return LPIPS(weights, biases, lin, device=device)


def lpips_from_jax_params(params: Dict[str, Any], device="cuda") -> LPIPS:
    """The JAX package's LPIPS params as numpy (``{"features": [{"kernel"
    (3, 3, in, out), "bias"}, ...], "lin": [(C,), ...]}``) -> ``LPIPS``."""
    weights = [np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
               for p in params["features"]]
    biases = [np.asarray(p["bias"]) for p in params["features"]]
    return LPIPS(weights, biases, [np.asarray(w) for w in params["lin"]],
                 device=device)
