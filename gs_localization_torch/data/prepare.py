"""Dataset prepare stages for Cambridge Landmarks, LLFF, and Mip-NeRF-360,
as the JAX package's ``data/prepare.py`` lays them out (host-only; PIL
resizes and reads the images).

Layouts:
- Cambridge: dataset_{train,test}.txt -> {train,test}_full.txt with
  seq/frame names flattened ('/' -> '_'), images resized to 1024x576 into
  images_full/ (+ train_images_full/ for train), per-image depths linked
  from a "Cambridge_additional"-style tree as <name>.depth.tiff, and the
  retriangulated model_train converted to a sparse/0 text model with the
  same flattened names and cameras rescaled to the new size.
- LLFF: image list from sparse/0 sorted by name, train = idx % 10 == 4
  (few-shot: ~10% of views train, the rest test), images taken from
  images_4/ (4x downsample), cameras rescaled to that resolution, split
  lists written to train_views/triangulated/list_{train,test}.txt.
- 360: the same with train = idx % 5 == 3.

Triangulating the train views belongs to the sfm stage; prepare only lays
out images, lists and the rescaled ground-truth model.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import numpy as np

from .colmap import (
    ColmapCamera,
    read_colmap_model,
    write_colmap_model_text,
)


def _resize_save(src: str, dsts: List[str], size: Tuple[int, int]) -> None:
    from PIL import Image

    with Image.open(src) as im:
        im = im.convert("RGB").resize(size)
        for d in dsts:
            im.save(d)


def _fresh_dir(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)


def _read_name_list(path: str) -> List[str]:
    """First token of each 'seqN/frame.png ...' line (Cambridge dataset_*.txt
    carry pose columns after the name; header lines don't start with seq)."""
    names = []
    if os.path.exists(path):
        for line in open(path):
            line = line.strip()
            if line.startswith("seq"):
                names.append(line.split()[0])
    return names


def rescale_camera(cam: ColmapCamera, new_width: int,
                   new_height: int) -> ColmapCamera:
    """Scale intrinsics to a new resolution; drop distortion to
    SIMPLE_PINHOLE the way the reference's adjust_camera_params does
    (train_test_split_llff.py:120-135)."""
    sx = new_width / cam.width
    sy = new_height / cam.height
    p = np.asarray(cam.params, np.float64)
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        f, cx, cy = p[0], p[1], p[2]
        params = [f * sx, cx * sx, cy * sy]
        model = "SIMPLE_PINHOLE"
    elif cam.model in ("PINHOLE", "OPENCV"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        params = [fx * sx, fy * sy, cx * sx, cy * sy]
        model = "PINHOLE"
    else:
        raise ValueError(f"unsupported camera model {cam.model}")
    return cam._replace(model=model, width=new_width, height=new_height,
                        params=np.asarray(params, np.float64))


def flatten_model_names(model_in: str, model_out: str) -> None:
    """Convert a COLMAP model (bin or text) to text with image names
    flattened seqN/frame.png -> seqN_frame.png (reference
    train_test_split_cambridge_full.py:276-311)."""
    cameras, images, points = read_colmap_model(model_in)
    images = {
        iid: im._replace(name=im.name.replace("/", "_"))
        for iid, im in images.items()
    }
    os.makedirs(model_out, exist_ok=True)
    write_colmap_model_text(model_out, cameras, images, points)


def prepare_cambridge(
    scene_path: str,
    out_path: Optional[str] = None,
    depth_dir: Optional[str] = None,
    size: Tuple[int, int] = (1024, 576),
    model_train_dir: str = "model_train",
) -> Tuple[List[str], List[str]]:
    """Cambridge split layout. Returns (train_names, test_names).

    ``depth_dir``: directory holding per-train-image depth files named
    <flat_name>.depth.tiff or .depth.png (the reference's
    Cambridge_additional/<scene>/train tree). Optional — RGB-only
    localization works without it (the Cambridge preset is monocular).
    """
    out_path = out_path or scene_path
    images_dir = os.path.join(out_path, "images_full")
    train_images_dir = os.path.join(out_path, "train_images_full")
    depths_dir = os.path.join(out_path, "depths_full")
    train_depths_dir = os.path.join(out_path, "train_depths_full")
    for d in (images_dir, train_images_dir, depths_dir, train_depths_dir):
        _fresh_dir(d)

    train = _read_name_list(os.path.join(scene_path, "dataset_train.txt"))
    test = _read_name_list(os.path.join(scene_path, "dataset_test.txt"))

    def link_depth(flat: str) -> None:
        if depth_dir is None:
            return
        base = flat[: -len(".png")] if flat.endswith(".png") else flat
        for suffix in (".depth.tiff", ".depth.png"):
            src = os.path.join(depth_dir, base + suffix)
            if os.path.exists(src):
                for d in (depths_dir, train_depths_dir):
                    dst = os.path.join(d, base + ".depth.tiff")
                    if not os.path.exists(dst):
                        os.symlink(os.path.abspath(src), dst)
                return

    train_flat, test_flat = [], []
    for rel in train:
        flat = rel.replace("/", "_")
        src = os.path.join(scene_path, rel)
        if not os.path.exists(src):
            continue
        _resize_save(src, [os.path.join(train_images_dir, flat),
                           os.path.join(images_dir, flat)], size)
        link_depth(flat)
        train_flat.append(flat)
    for rel in test:
        flat = rel.replace("/", "_")
        src = os.path.join(scene_path, rel)
        if not os.path.exists(src):
            continue
        _resize_save(src, [os.path.join(images_dir, flat)], size)
        test_flat.append(flat)

    with open(os.path.join(out_path, "train_full.txt"), "w") as f:
        f.write("".join(n + "\n" for n in train_flat))
    with open(os.path.join(out_path, "test_full.txt"), "w") as f:
        f.write("".join(n + "\n" for n in test_flat))

    model_in = os.path.join(scene_path, model_train_dir)
    if os.path.isdir(model_in):
        sparse = os.path.join(out_path, "sparse", "0")
        flatten_model_names(model_in, sparse)
        # rescale the model cameras to the resized image resolution
        cameras, images, points = read_colmap_model(sparse)
        cameras = {cid: rescale_camera(c, size[0], size[1])
                   for cid, c in cameras.items()}
        write_colmap_model_text(sparse, cameras, images, points)
    return train_flat, test_flat


def prepare_llff_style(
    scene_path: str,
    llffhold: int,
    train_residue: int,
    images_subdir: str = "images_4",
    model_dir: str = "sparse/0",
) -> Tuple[List[str], List[str]]:
    """Shared LLFF/360 layout: train_views/{images, train_images,
    triangulated/list_{train,test}.txt, sparse_gt/0}. Returns the split."""
    cameras, images, _ = read_colmap_model(os.path.join(scene_path, model_dir))
    names = sorted(im.name for im in images.values())
    train = [n for i, n in enumerate(names) if i % llffhold == train_residue]
    test = [n for i, n in enumerate(names) if i % llffhold != train_residue]

    view_path = os.path.join(scene_path, "train_views")
    img_out = os.path.join(view_path, "images")
    train_out = os.path.join(view_path, "train_images")
    tri = os.path.join(view_path, "triangulated")
    for d in (img_out, train_out, tri):
        _fresh_dir(d)

    src_dir = os.path.join(scene_path, images_subdir)
    # images_4 entries may carry a different extension; match by stem
    by_stem = {os.path.splitext(f)[0]: f for f in sorted(os.listdir(src_dir))}
    sample = None
    for n in names:
        stem = os.path.splitext(n)[0]
        f = by_stem.get(stem, n)
        src = os.path.join(src_dir, f)
        if not os.path.exists(src):
            continue
        dst = os.path.join(img_out, n)
        shutil.copyfile(src, dst)
        if n in train:
            shutil.copyfile(src, os.path.join(train_out, n))
        sample = sample or dst

    with open(os.path.join(tri, "list_train.txt"), "w") as f:
        f.write("".join(n + "\n" for n in train))
    with open(os.path.join(tri, "list_test.txt"), "w") as f:
        f.write("".join(n + "\n" for n in test))

    # ground-truth model rescaled to the downsampled resolution
    from PIL import Image

    assert sample is not None, f"no images found under {src_dir}"
    with Image.open(sample) as im:
        new_w, new_h = im.size
    cameras = {cid: rescale_camera(c, new_w, new_h)
               for cid, c in cameras.items()}
    gt = os.path.join(view_path, "sparse_gt", "0")
    os.makedirs(gt, exist_ok=True)
    write_colmap_model_text(gt, cameras, images, {})
    return train, test


def prepare_llff(scene_path: str) -> Tuple[List[str], List[str]]:
    """LLFF: hold 10, train = idx %% 10 == 4 (train_test_split_llff.py:174)."""
    return prepare_llff_style(scene_path, llffhold=10, train_residue=4)


def prepare_360(scene_path: str) -> Tuple[List[str], List[str]]:
    """Mip-360: hold 5, train = idx %% 5 == 3 (train_test_split_360.py:177)."""
    return prepare_llff_style(scene_path, llffhold=5, train_residue=3)


def load_llff_scene(scene_path: str, device="cuda"):
    """Scene over the prepare_llff_style layout (gt poses, list splits), on
    ``device``."""
    from .scene import load_colmap_scene

    view_path = os.path.join(scene_path, "train_views")
    tri = os.path.join(view_path, "triangulated")

    def read_list(p):
        return [l.strip() for l in open(p) if l.strip()]

    return load_colmap_scene(
        os.path.join(view_path, "sparse_gt", "0"),
        images_dir=os.path.join(view_path, "images"),
        train_list=read_list(os.path.join(tri, "list_train.txt")),
        test_list=read_list(os.path.join(tri, "list_test.txt")),
        device=device,
    )
