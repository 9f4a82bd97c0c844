"""NetVLAD global descriptor, on the port.

hloc's NetVLAD extractor as the JAX package's ``sfm/netvlad.py`` computes
it: VGG16 truncated after conv5_3 (no final ReLU), channel-normalised
features, 64-cluster NetVLAD pooling (softmax cluster scores, residuals to
the centres, intra-normalisation), flatten + L2, and a 32,768 x 4,096
whitening projection + L2.

Weights are the JAX package's params tree (``netvlad_from_jax_params``) or
hloc's ``Pitts30K_struct.mat`` MatConvNet export (``load_netvlad_mat``,
with hloc's layer indices and sign conventions), held in a ``ParamTree``;
the convolutions are ``F.conv2d`` under ``float32_exact``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import float32_exact, resolve_device
from ..ops.param_tree import ParamTree

NUM_CLUSTERS = 64
FEATURE_DIM = 512
OUTPUT_DIM = 4096

# VGG16 conv plan: (out_channels, pool_before) for the 13 convs; ReLU after
# every conv except the last (hloc drops the final ReLU + max-pool).
VGG16_CONVS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
POOL_BEFORE = (False, False, True, False, True, False, False, True,
               False, False, True, False, False)
# hloc's indices of the NetVLAD and whitening layers in net.layers
NETVLAD_LAYER, WHITEN_LAYER = 30, 33


class NetVLAD(ParamTree):
    """``mean`` (3,), ``features`` (13 x {kernel, bias}), ``score_w`` and
    ``centers`` (512, 64), ``whiten`` {w (32768, 4096), b (4096,)}."""

    def __init__(self, params: Dict[str, Any], device="cuda"):
        super().__init__(params, resolve_device(device))
        self.requires_grad_(False)
        self.eval()

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return netvlad_descriptor(self, image)


def backbone_features(p: NetVLAD, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) image in [0, 1] -> (H/16 * W/16, 512) conv5_3 features."""
    x = torch.clamp(image * 255.0, 0.0, 255.0) - p["mean"]
    x = x.permute(2, 0, 1)[None]
    for i in range(len(VGG16_CONVS)):
        if POOL_BEFORE[i]:
            x = F.max_pool2d(x, 2, 2)
        f = p["features"][i]
        x = F.conv2d(x, f["kernel"], f["bias"], padding=1)
        if i < len(VGG16_CONVS) - 1:
            x = F.relu(x)
    return x[0].permute(1, 2, 0).reshape(-1, FEATURE_DIM)


def netvlad_pool(p: NetVLAD, feats: torch.Tensor) -> torch.Tensor:
    """(N, 512) features -> (512 * 64,) VLAD vector (before whitening)."""
    f = feats * torch.rsqrt(torch.clamp_min(
        torch.sum(feats * feats, -1, keepdim=True), 1e-24))
    scores = torch.softmax(f @ p["score_w"], dim=-1)              # (N, K)
    # desc[d, k] = sum_n scores[n, k] * (f[n, d] - centers[d, k])
    desc = torch.einsum("nd,nk->dk", f, scores) \
        - p["centers"] * torch.sum(scores, 0)[None, :]
    desc = desc * torch.rsqrt(torch.clamp_min(
        torch.sum(desc * desc, 0, keepdim=True), 1e-24))
    v = desc.reshape(-1)                                          # D-major
    return v / torch.clamp_min(torch.linalg.norm(v), 1e-12)


@torch.no_grad()
def netvlad_descriptor(p: NetVLAD, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) image in [0, 1] on the net's device -> (4096,) whitened
    global descriptor."""
    with float32_exact():
        v = netvlad_pool(p, backbone_features(p, image))
        w = v @ p["whiten"]["w"] + p["whiten"]["b"]
    return w / torch.clamp_min(torch.linalg.norm(w), 1e-12)


def batch_descriptors(p: NetVLAD, images: Sequence) -> np.ndarray:
    """Same-size (H, W, 3) images -> (B, 4096) descriptors (host-side)."""
    dev = p["mean"].device
    return np.stack([
        netvlad_descriptor(p, torch.as_tensor(np.asarray(im, np.float32),
                                              device=dev)).cpu().numpy()
        for im in images])


def init_params(rng: np.random.Generator) -> Dict[str, Any]:
    """Random weights (numpy), the JAX package's ``init_params`` draws."""
    feats, cin = [], 3
    for cout in VGG16_CONVS:
        k = (rng.standard_normal((3, 3, cin, cout)) *
             np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        feats.append({"kernel": k, "bias": np.zeros(cout, np.float32)})
        cin = cout
    return {
        "mean": rng.uniform(100, 140, 3).astype(np.float32),
        "features": feats,
        "score_w": 0.1 * rng.standard_normal(
            (FEATURE_DIM, NUM_CLUSTERS)).astype(np.float32),
        "centers": 0.1 * rng.standard_normal(
            (FEATURE_DIM, NUM_CLUSTERS)).astype(np.float32),
        "whiten": {
            "w": 0.01 * rng.standard_normal(
                (FEATURE_DIM * NUM_CLUSTERS, OUTPUT_DIM)).astype(np.float32),
            "b": np.zeros(OUTPUT_DIM, np.float32)},
    }


def write_netvlad_mat(params: Dict[str, Any], mat_path: str) -> None:
    """Write a params tree as a MatConvNet ``*_struct.mat`` in hloc's
    layout (the inverse of ``read_netvlad_mat``): VGG16's conv / relu /
    pool layers 0-28, NetVLAD at 30, the whitening conv at 33."""
    from scipy.io import savemat

    def cell(*arrays):
        out = np.empty(len(arrays), dtype=object)
        out[:] = arrays
        return out

    layers = []
    for i, f in enumerate(params["features"]):
        if POOL_BEFORE[i]:
            layers.append({"type": "pool"})
        layers.append({"type": "conv", "weights": cell(
            np.asarray(f["kernel"], np.float32),
            np.asarray(f["bias"], np.float32))})
        if i < len(VGG16_CONVS) - 1:
            layers.append({"type": "relu"})
    layers.append({"type": "normalize"})
    assert len(layers) == NETVLAD_LAYER
    layers.append({"type": "netvlad", "weights": cell(
        np.asarray(params["score_w"], np.float32),
        -np.asarray(params["centers"], np.float32))})
    layers += [{"type": "normalize"}, {"type": "normalize"}]
    w = np.asarray(params["whiten"]["w"], np.float32)
    layers.append({"type": "conv", "weights": cell(
        w.reshape(1, 1, *w.shape), np.asarray(params["whiten"]["b"],
                                              np.float32))})
    mean = np.asarray(params["mean"], np.float32).reshape(1, 1, 3)
    savemat(mat_path, {"net": {
        "layers": cell(*layers),
        "meta": {"normalization": {"averageImage": mean}}}})


def netvlad_from_jax_params(params: Dict[str, Any], device="cuda") -> NetVLAD:
    """The JAX package's params tree (numpy; kernels HWIO) -> the net."""
    return NetVLAD(params, device)


def read_netvlad_mat(mat_path: str) -> Dict[str, Any]:
    """A MatConvNet ``*_struct.mat`` export (hloc's checkpoint format) as
    the JAX package's params tree of numpy arrays.

    hloc's conventions: conv weights are stored S x S x IN x OUT (already
    HWIO); layer 30 holds (score_w D x K, -centers D x K); layer 33 the
    whitening (1 x 1 x IN x OUT, OUT); the image mean is
    net.meta.normalization.averageImage."""
    from scipy.io import loadmat

    mat = loadmat(mat_path, struct_as_record=False, squeeze_me=True)
    layers = mat["net"].layers
    feats = []
    for layer in layers:
        if getattr(layer, "type", "") == "conv" and len(feats) < 13:
            w, b = layer.weights[0], layer.weights[1]
            if w.ndim != 4 or w.shape[0] != 3:
                continue
            feats.append({"kernel": np.asarray(w, np.float32),
                          "bias": np.asarray(b, np.float32).reshape(-1)})
    if len(feats) != 13:
        raise ValueError(f"expected 13 conv layers, found {len(feats)}")
    vlad, white = layers[NETVLAD_LAYER], layers[WHITEN_LAYER]
    ww = np.asarray(white.weights[0], np.float32)
    return {
        "mean": np.asarray(mat["net"].meta.normalization.averageImage,
                           np.float32).reshape(-1)[:3],
        "features": feats,
        "score_w": np.asarray(vlad.weights[0], np.float32),
        "centers": -np.asarray(vlad.weights[1], np.float32),
        "whiten": {"w": ww.reshape(-1, OUTPUT_DIM),
                   "b": np.asarray(white.weights[1],
                                   np.float32).reshape(-1)},
    }


def load_netvlad_mat(mat_path: str, device="cuda") -> NetVLAD:
    """hloc's ``Pitts30K_struct.mat`` -> the net on ``device``."""
    return NetVLAD(read_netvlad_mat(mat_path), device)
