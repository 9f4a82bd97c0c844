"""hloc-style conf registry for extractors / matchers / retrieval, on the
port.

The conf names and tables of the JAX package's ``sfm/registry.py`` (hloc's
``extract_features`` / ``match_features`` confs). Learned confs take the
network that ``weights.load`` returns as ``params``; classical confs
(harris, sift, the NN matchers, adalam, tiny) need none.

  extractor = get_extractor("superpoint_max", params=sp_net)
  feats = extractor(image)                        # -> Features

  matcher = get_matcher("superglue", params=sg_net)
  res = matcher(feats0, feats1, shape0, shape1)   # -> SuperGlueResult

  matcher, cfg = get_dense_matcher("loftr", params=loftr_net)
  kpts0, kpts1, scores = matcher(image0, image1)

Images may be tensors (they run on their own device) or numpy arrays (they
go to the network's device, else to ``device``). Every kind of the JAX
package's registry is served.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from .features import Features, extract_harris_features, rgb_to_gray

# extractor conf name -> (module kind, default kwargs). Mirrors hloc's
# superpoint_{aachen,max,inloc}, r2d2, d2net-ss, sift, disk confs.
EXTRACTOR_CONFS: Dict[str, Dict[str, Any]] = {
    "harris": {"kind": "harris", "num_keypoints": 1024},
    "superpoint_aachen": {"kind": "superpoint", "num_keypoints": 4096,
                          "nms_radius": 3},
    "superpoint_max": {"kind": "superpoint", "num_keypoints": 4096,
                       "nms_radius": 3},
    "superpoint_inloc": {"kind": "superpoint", "num_keypoints": 4096,
                         "nms_radius": 4},
    "r2d2": {"kind": "r2d2", "num_keypoints": 5000},
    "d2net-ss": {"kind": "d2net", "num_keypoints": 5000},
    "sift": {"kind": "sift", "num_keypoints": 4096},
    "dog": {"kind": "sift", "num_keypoints": 4096},
    "disk": {"kind": "disk", "num_keypoints": 5000, "nms_window_size": 5},
}

MATCHER_CONFS: Dict[str, Dict[str, Any]] = {
    "superglue": {"kind": "superglue", "sinkhorn_iterations": 50},
    "superglue-fast": {"kind": "superglue", "sinkhorn_iterations": 5},
    "superpoint+lightglue": {"kind": "lightglue"},
    "lightglue": {"kind": "lightglue"},
    "NN-ratio": {"kind": "nn", "ratio_thresh": 0.8},
    "NN-mutual": {"kind": "nn", "ratio_thresh": 1.0},
    # host-side spatial-consistency filter; no learned weights
    "adalam": {"kind": "adalam"},
}

RETRIEVAL_CONFS: Dict[str, Dict[str, Any]] = {
    "netvlad": {"kind": "netvlad"},
    "dir": {"kind": "dir"},
    "openibl": {"kind": "openibl"},
    "eigenplaces": {"kind": "eigenplaces"},
    "cosplace": {"kind": "eigenplaces"},     # same architecture family
    "tiny": {"kind": "tiny"},
}

# dense-matcher confs: quantization pitches of the keypoint aggregation
# (hloc match_dense confs 'loftr' 1/1, 'loftr_aachen' 2/8,
# 'loftr_superpoint' 4/4)
DENSE_CONFS: Dict[str, Dict[str, Any]] = {
    "loftr": {"kind": "loftr", "max_error": 1.0, "cell_size": 1.0},
    "loftr_aachen": {"kind": "loftr", "max_error": 2.0, "cell_size": 8.0},
    "loftr_superpoint": {"kind": "loftr", "max_error": 4.0, "cell_size": 4.0},
}


def _device_of(net: torch.nn.Module) -> torch.device:
    return next(net.parameters()).device


def _tensor(img, device) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img.to(torch.float32)
    return torch.as_tensor(np.asarray(img, np.float32),
                           device=resolve_device(device))


def _gray(img, dev) -> torch.Tensor:
    img = _tensor(img, dev)
    return rgb_to_gray(img) if img.ndim == 3 else img


def _rgb(img, dev) -> torch.Tensor:
    img = _tensor(img, dev)
    return torch.stack([img, img, img], -1) if img.ndim == 2 else img


def get_extractor(conf: str, params: Optional[Any] = None, device="cuda",
                  **overrides) -> Callable[[Any], Features]:
    """Returns ``extractor(image_rgb_or_gray) -> Features``."""
    if conf not in EXTRACTOR_CONFS:
        raise KeyError(f"unknown extractor conf '{conf}'; "
                       f"have {sorted(EXTRACTOR_CONFS)}")
    cfg = {**EXTRACTOR_CONFS[conf], **overrides}
    kind = cfg.pop("kind")
    if kind == "harris":
        return lambda img: extract_harris_features(
            _gray(img, device), num_keypoints=cfg["num_keypoints"])
    if kind == "sift":
        from .sift import extract_sift

        return lambda img: extract_sift(
            _gray(img, device), num_keypoints=cfg["num_keypoints"])
    if params is None:
        raise ValueError(f"conf '{conf}' needs a loaded network (params)")
    dev = _device_of(params)
    n = cfg["num_keypoints"]
    if kind == "superpoint":
        from .superpoint import extract_superpoint

        return lambda img: extract_superpoint(
            params, _gray(img, dev), num_keypoints=n,
            nms_radius=cfg.get("nms_radius", 4))
    if kind == "r2d2":
        from .r2d2 import extract_r2d2

        return lambda img: extract_r2d2(params, _rgb(img, dev),
                                        num_keypoints=n)
    if kind == "d2net":
        from .d2net import extract_d2net

        return lambda img: extract_d2net(params, _rgb(img, dev),
                                         num_keypoints=n)
    if kind == "disk":
        from .disk import extract_disk

        return lambda img: extract_disk(
            params, _rgb(img, dev), num_keypoints=n,
            window_size=cfg.get("nms_window_size", 5))
    raise KeyError(kind)


def get_matcher(conf: str, params: Optional[Any] = None, **overrides):
    """Returns ``matcher(f0, f1, (w0, h0), (w1, h1))`` -> a result with
    ``.matches0``."""
    if conf not in MATCHER_CONFS:
        raise KeyError(f"unknown matcher conf '{conf}'; "
                       f"have {sorted(MATCHER_CONFS)}")
    cfg = {**MATCHER_CONFS[conf], **overrides}
    kind = cfg.pop("kind")
    if kind == "adalam":
        from .adalam import AdalamConfig, adalam_match

        acfg = AdalamConfig(**cfg)
        return lambda f0, f1, s0, s1: adalam_match(f0, f1, s0, s1,
                                                   config=acfg)
    if kind == "nn":
        from .matching import match_mutual_nn

        return lambda f0, f1, s0=None, s1=None: match_mutual_nn(
            f0.descriptors, f1.descriptors, f0.scores > 0, f1.scores > 0,
            ratio_thresh=cfg["ratio_thresh"])
    if params is None:
        raise ValueError(f"conf '{conf}' needs a loaded network (params)")
    if kind == "superglue":
        from .superglue import superglue_match

        return lambda f0, f1, s0, s1: superglue_match(
            params, f0.keypoints, f0.scores, f0.descriptors,
            f1.keypoints, f1.scores, f1.descriptors,
            s0[0], s0[1], s1[0], s1[1],
            sinkhorn_iters=cfg["sinkhorn_iterations"])
    if kind == "lightglue":
        from .lightglue import lightglue_match

        return lambda f0, f1, s0, s1: lightglue_match(
            params, f0.keypoints, f0.descriptors,
            f1.keypoints, f1.descriptors, s0[0], s0[1], s1[0], s1[1])
    raise KeyError(kind)


def get_dense_matcher(conf: str, params: Optional[Any] = None,
                      **overrides):
    """Returns ``(matcher(img0, img1) -> (kpts0, kpts1, scores), cfg)``
    where cfg carries the aggregation pitches (max_error, cell_size) for
    ``sfm.match_dense.aggregate_dense_matches`` / ``SfmInitConfig``."""
    if conf not in DENSE_CONFS:
        raise KeyError(f"unknown dense conf '{conf}'; "
                       f"have {sorted(DENSE_CONFS)}")
    cfg = {**DENSE_CONFS[conf], **overrides}
    kind = cfg.pop("kind")
    if params is None:
        raise ValueError(f"conf '{conf}' needs a loaded network (params)")
    if kind != "loftr":
        raise KeyError(kind)
    from .loftr import loftr_match

    dev = _device_of(params)

    def matcher(img0, img1):
        m = loftr_match(params, _gray(img0, dev), _gray(img1, dev))
        return m.kpts0, m.kpts1, m.scores

    return matcher, cfg


def get_global_descriptor(conf: str, params: Optional[Any] = None,
                          device="cuda"):
    """Returns ``fn(image_rgb) -> (D,) descriptor`` for retrieval."""
    if conf not in RETRIEVAL_CONFS:
        raise KeyError(f"unknown retrieval conf '{conf}'")
    kind = RETRIEVAL_CONFS[conf]["kind"]
    if kind == "tiny":
        from .features import tiny_image_descriptor

        return lambda img: tiny_image_descriptor(_tensor(img, device))
    if params is None:
        raise ValueError(f"'{conf}' needs a loaded network (params)")
    dev = _device_of(params)
    if kind == "dir":
        from .dir import dir_descriptor

        return lambda img: dir_descriptor(params, _rgb(img, dev))
    if kind == "openibl":
        from .openibl import openibl_descriptor

        return lambda img: openibl_descriptor(params, _rgb(img, dev))
    if kind == "eigenplaces":
        from .eigenplaces import eigenplaces_descriptor

        return lambda img: eigenplaces_descriptor(params, _rgb(img, dev))
    from .netvlad import netvlad_descriptor

    return lambda img: netvlad_descriptor(params, _tensor(img, dev))
