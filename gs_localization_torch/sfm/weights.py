"""Checkpoint manifest and loader, on the port (see WEIGHTS.md).

The same rows as the JAX package's ``sfm/weights.py``: each official
checkpoint's file name and source. ``load`` turns a user-supplied file
into the port's network, an ``nn.Module`` in eval mode on ``device``:

    from gs_localization_torch.sfm import weights
    net = weights.load("superpoint", "/weights/superpoint_v1.pth")

or, for every manifest file found in a directory:

    python -m gs_localization_torch.sfm.weights --check /weights

which loads each recognised file, prints its parameter count and a sha256
(record it the first time; pin it thereafter), and exits non-zero if a
present file fails to load. Five rows load into port networks
(SuperPoint, SuperGlue indoor / outdoor, NetVLAD, DPT_Hybrid, MiDaS
v2.1); the networks of the other rows are not ported yet and raise
``NotImplementedError``.

``write_random`` writes a checkpoint of random weights made from a seed at
the official shapes, under the official name and in the official format,
for runs without the real files (tests, the card smoke test).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

_TODO = "(ROADMAP.md §1 item 5, networks)"


def _torch_sd(path: str) -> Dict[str, Any]:
    """A torch checkpoint as a flat name -> tensor dict (CPU).

    Safe by default: ``weights_only=True`` (no arbitrary unpickling of a
    downloaded file). A few official checkpoints wrap their tensors in
    pickled objects; for those, set GSLOC_ALLOW_PICKLE=1 after checking
    the file's provenance / hash (WEIGHTS.md step 2).
    """
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if os.environ.get("GSLOC_ALLOW_PICKLE") != "1":
            raise RuntimeError(
                f"{path} is not a plain tensor checkpoint "
                f"(weights_only load failed: {e}). If you trust the file, "
                "re-run with GSLOC_ALLOW_PICKLE=1.") from e
        obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: v for k, v in obj.items() if hasattr(v, "shape")}


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    file: str            # expected file name (the official release name)
    source: str          # where the user downloads it (official URL / repo)
    load: Callable[[str, Any], torch.nn.Module]   # (path, device) -> net
    note: str = ""


def _sp(path, device):
    from .superpoint import load_superpoint
    return load_superpoint(_torch_sd(path), device)


def _sg(path, device):
    from .superglue import load_superglue
    return load_superglue(_torch_sd(path), device)


def _netvlad(path, device):
    from .netvlad import load_netvlad_mat
    return load_netvlad_mat(path, device)


def _dpt(path, device):
    from ..ops.dpt import load_dpt
    return load_dpt(_torch_sd(path), device)


def _midas(path, device):
    from ..ops.midas import load_midas
    return load_midas(_torch_sd(path), device)


def _not_ported(name: str):
    def load(path, device):
        raise NotImplementedError(
            f"the {name} network is not ported yet {_TODO}")
    return load


MANIFEST: Dict[str, WeightSpec] = {
    "superpoint": WeightSpec(
        "superpoint_v1.pth",
        "github.com/magicleap/SuperGluePretrainedNetwork "
        "(models/weights/superpoint_v1.pth)",
        _sp),
    "superglue_outdoor": WeightSpec(
        "superglue_outdoor.pth",
        "github.com/magicleap/SuperGluePretrainedNetwork "
        "(models/weights/superglue_outdoor.pth)",
        _sg, "the reference's SfM matcher (sinkhorn 5/50)"),
    "superglue_indoor": WeightSpec(
        "superglue_indoor.pth",
        "github.com/magicleap/SuperGluePretrainedNetwork "
        "(models/weights/superglue_indoor.pth)",
        _sg),
    "lightglue": WeightSpec(
        "superpoint_lightglue.pth",
        "github.com/cvg/LightGlue (release asset superpoint_lightglue.pth)",
        _not_ported("lightglue")),
    "loftr_outdoor": WeightSpec(
        "outdoor_ds.ckpt",
        "github.com/zju3dv/LoFTR (release weights, outdoor_ds.ckpt)",
        _not_ported("loftr_outdoor")),
    "d2net": WeightSpec(
        "d2_tf.pth",
        "dsmn.ml/files/d2-net/d2_tf.pth (github.com/mihaidusmanu/d2-net)",
        _not_ported("d2net")),
    "r2d2": WeightSpec(
        "r2d2_WASF_N16.pt",
        "github.com/naver/r2d2 (models/r2d2_WASF_N16.pt)",
        _not_ported("r2d2")),
    "disk": WeightSpec(
        "depth-save.pth",
        "github.com/cvlab-epfl/disk (depth-save.pth release)",
        _not_ported("disk")),
    "netvlad": WeightSpec(
        "Pitts30K_struct.mat",
        "cvg-data.inf.ethz.ch/hloc/netvlad/Pitts30K_struct.mat "
        "(hloc's mirror of the matconvnet VGG16+NetVLAD whitened model)",
        _netvlad, "the reference's retrieval model (hloc netvlad conf)"),
    "dir": WeightSpec(
        "Resnet101-AP-GeM-LM18.pt",
        "github.com/naver/deep-image-retrieval (Resnet101-AP-GeM-LM18)",
        _not_ported("dir")),
    "openibl": WeightSpec(
        "vgg16_netvlad.pth",
        "github.com/yxgeee/OpenIBL (hub vgg16_netvlad)",
        _not_ported("openibl")),
    "eigenplaces": WeightSpec(
        "ResNet50_2048_eigenplaces.pth",
        "github.com/gmberton/EigenPlaces (hub ResNet50, fc_output_dim 2048)",
        _not_ported("eigenplaces")),
    "dpt_hybrid": WeightSpec(
        "dpt_hybrid-midas-501f0c75.pt",
        "github.com/isl-org/MiDaS (release dpt_hybrid-midas-501f0c75.pt)",
        _dpt, "the reference's monocular depth prior "
              "(utils/depth_utils.py DPT_Hybrid)"),
    "midas_v21": WeightSpec(
        "midas_v21-f6b98070.pt",
        "github.com/isl-org/MiDaS (release midas_v21-f6b98070.pt)",
        _midas, "fallback depth prior (smaller, ResNeXt101 backbone)"),
}


def load(name: str, path: Optional[str] = None,
         device="cuda") -> torch.nn.Module:
    """The named official checkpoint as the port's network on ``device``.

    ``path`` defaults to ``$GSLOC_WEIGHTS_DIR/<manifest filename>``.
    """
    spec = MANIFEST[name]
    if path is None:
        wdir = os.environ.get("GSLOC_WEIGHTS_DIR")
        if not wdir:
            raise FileNotFoundError(
                f"no path given and GSLOC_WEIGHTS_DIR unset — expected "
                f"{spec.file} (from {spec.source}); see WEIGHTS.md")
        path = os.path.join(wdir, spec.file)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — download {spec.file} from {spec.source} "
            "(see WEIGHTS.md)")
    return spec.load(path, device)


def n_params(net: torch.nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())


def check_dir(wdir: str, device="cuda") -> Dict[str, str]:
    """Load every manifest file present in ``wdir``; return
    name -> 'ok (N params, sha256 ...)' / 'missing' / 'FAILED: ...'."""
    out = {}
    for name, spec in MANIFEST.items():
        path = os.path.join(wdir, spec.file)
        if not os.path.exists(path):
            out[name] = "missing"
            continue
        try:
            net = load(name, path, device)
            with open(path, "rb") as f:
                sha = hashlib.sha256(f.read()).hexdigest()[:16]
            out[name] = f"ok ({n_params(net):,} params, sha256 {sha}…)"
        except Exception as e:  # report it and go on with the sweep
            out[name] = f"FAILED: {type(e).__name__}: {e}"
    return out


# --------------------------------------------------- random checkpoints ----
def write_random(name: str, wdir: str, seed: int = 0) -> str:
    """Write random weights made from ``seed`` as the official checkpoint of
    ``name`` (its shapes, file name and format) into ``wdir``; returns the
    path.

    SuperPoint: normal kernels at LeCun scale (1 / sqrt(fan_in), as flax
    initialises the JAX package's net) and zero biases, the detector's
    logits scaled by 100: a trained detector's scores are peaked, and at
    an untrained one's they all sit near 1 / 65, below the localize
    masks' 0.2 and often tied. SuperGlue: PyTorch's default
    initialisation (batch norms at their initial statistics). NetVLAD, DPT
    and MiDaS: the JAX package's ``init_params`` draws."""
    spec = MANIFEST[name]
    path = os.path.join(wdir, spec.file)
    if name == "superpoint":
        from .superpoint import SuperPointNet

        rng = np.random.default_rng(seed)
        sd = {}
        for key, v in SuperPointNet("cpu").state_dict().items():
            if key.endswith(".bias"):
                a = np.zeros(v.shape, np.float32)
            else:
                fan_in = int(np.prod(v.shape[1:]))
                a = (rng.standard_normal(v.shape)
                     / np.sqrt(fan_in)).astype(np.float32)
            if key.startswith("convPb."):
                a = a * np.float32(100.0)
            sd[key] = torch.from_numpy(a)
        torch.save(sd, path)
    elif name in ("superglue_outdoor", "superglue_indoor"):
        from .superglue import SuperGlueNet

        torch.manual_seed(seed)
        torch.save(SuperGlueNet("cpu").state_dict(), path)
    elif name == "netvlad":
        from .netvlad import init_params, write_netvlad_mat

        write_netvlad_mat(init_params(np.random.default_rng(seed)), path)
    elif name == "dpt_hybrid":
        from ..ops.dpt import dpt_state_dict, init_params

        sd = dpt_state_dict(init_params(np.random.default_rng(seed)))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    elif name == "midas_v21":
        from ..ops.midas import init_params, midas_state_dict

        sd = midas_state_dict(init_params(np.random.default_rng(seed)))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    else:
        raise NotImplementedError(
            f"the {name} network is not ported yet {_TODO}")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", metavar="DIR",
                    help="load every recognised checkpoint in DIR")
    ap.add_argument("--list", action="store_true",
                    help="print the manifest (file, source) table")
    ap.add_argument("--device", default="cuda",
                    help="where --check loads the networks (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.list or not args.check:
        for name, spec in MANIFEST.items():
            print(f"{name:20s} {spec.file:36s} {spec.source}")
        return
    results = check_dir(args.check, args.device)
    failed = False
    for name, status in results.items():
        print(f"{name:20s} {MANIFEST[name].file:36s} {status}")
        failed |= status.startswith("FAILED")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
