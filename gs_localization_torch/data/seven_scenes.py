"""7-Scenes dataset preparation and loading.

The conventions of the reference's 7-Scenes preparation, as the JAX
package's ``data/seven_scenes.py`` implements them:

- flat naming: ``seq-XX/frame-YYYYYY.color.png`` -> ``seq-XX-frame-YYYYYY-color.png``;
  depth partner obtained by ``color -> depth`` name rewrite;
- ``TrainSplit.txt`` / ``TestSplit.txt`` lines ``sequenceN`` select the
  seq dirs for each split; ``train_full.txt`` / ``test_full.txt`` list the
  flat names;
- ground-truth poses come from a COLMAP model (``sparse_dslam/0`` = the
  7-Scenes DSLAM pseudo-gt converted to COLMAP, image names flattened).

We build the flat layout with symlinks (identical artifact structure, so
existing hloc/COLMAP runs interoperate), and expose a
``load_seven_scenes_scene`` that assembles a SceneInfo directly.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .scene import SceneInfo, load_colmap_scene


def flat_name(seq_dir: str, image_name: str) -> str:
    """'seq-01', 'frame-000123.color.png' -> 'seq-01-frame-000123-color.png'."""
    return f"{seq_dir}-{image_name}".replace(".color.png", "-color.png")


def seq_dir_from_split_line(line: str) -> Optional[str]:
    """'sequence3' -> 'seq-03'; 'sequence12' -> 'seq-12'."""
    line = line.strip()
    if not line.startswith("sequence"):
        return None
    num = line[len("sequence"):]
    return f"seq-{num}" if len(num) > 1 else f"seq-0{num}"


def _link(src: str, dst: str) -> None:
    if os.path.lexists(dst):
        os.remove(dst)
    os.symlink(src, dst)


def prepare_scene(
    scene_path: str,
    out_path: Optional[str] = None,
    depth_suffix: str = ".depth.png",
) -> Tuple[List[str], List[str]]:
    """Build the flat split layout for one 7-Scenes scene directory
    (containing seq-XX/ dirs + TrainSplit.txt/TestSplit.txt).

    Returns (train_names, test_names) and writes under ``out_path``:
    images_full/, train_images_full/, depths_full/, train_full.txt,
    test_full.txt — the reference's artifact layout.
    """
    out_path = out_path or scene_path
    images_dir = os.path.join(out_path, "images_full")
    train_images_dir = os.path.join(out_path, "train_images_full")
    depths_dir = os.path.join(out_path, "depths_full")
    for d in (images_dir, train_images_dir, depths_dir):
        os.makedirs(d, exist_ok=True)

    def read_split(fname):
        path = os.path.join(scene_path, fname)
        seqs = []
        if os.path.exists(path):
            for line in open(path):
                s = seq_dir_from_split_line(line)
                if s:
                    seqs.append(s)
        return seqs

    train_seqs = read_split("TrainSplit.txt")
    test_seqs = read_split("TestSplit.txt")

    def process(seqs, is_train):
        names = []
        for seq in seqs:
            seq_path = os.path.join(scene_path, seq)
            if not os.path.isdir(seq_path):
                continue
            for image_name in sorted(os.listdir(seq_path)):
                if not image_name.endswith("color.png"):
                    continue
                fname = flat_name(seq, image_name)
                names.append(fname)
                src = os.path.join(seq_path, image_name)
                _link(src, os.path.join(images_dir, fname))
                if is_train:
                    _link(src, os.path.join(train_images_dir, fname))
                dsrc = os.path.join(
                    seq_path, image_name.replace(".color.png", depth_suffix))
                if os.path.exists(dsrc):
                    _link(dsrc, os.path.join(
                        depths_dir, fname.replace("color", "depth")))
        return names

    train_names = process(train_seqs, True)
    test_names = process(test_seqs, False)
    with open(os.path.join(out_path, "train_full.txt"), "w") as f:
        f.write("\n".join(train_names) + ("\n" if train_names else ""))
    with open(os.path.join(out_path, "test_full.txt"), "w") as f:
        f.write("\n".join(test_names) + ("\n" if test_names else ""))
    return train_names, test_names


def flatten_colmap_image_names(images_txt_path: str) -> None:
    """Rewrite 'seq/frame.color.png' names in a COLMAP images.txt to the
    flat convention (reference pipeline() post-processing)."""
    with open(images_txt_path) as f:
        lines = f.readlines()
    out = []
    for line in lines:
        elems = line.split()
        if line.startswith("#") or len(elems) != 10:
            out.append(line)
            continue
        elems[9] = elems[9].replace("/", "-").replace(".color.png",
                                                      "-color.png")
        out.append(" ".join(elems) + "\n")
    with open(images_txt_path, "w") as f:
        f.writelines(out)


def load_seven_scenes_scene(
    scene_path: str,
    model_dir: str = "sparse_dslam/0",
    train_list_file: str = "train_full.txt",
    test_list_file: str = "test_full.txt",
    device="cuda",
) -> SceneInfo:
    """The prepared flat layout as a SceneInfo on ``device``."""
    def read_list(fname):
        p = os.path.join(scene_path, fname)
        if not os.path.exists(p):
            return None
        return [l.strip() for l in open(p) if l.strip()]

    return load_colmap_scene(
        os.path.join(scene_path, model_dir),
        images_dir=os.path.join(scene_path, "images_full"),
        depths_dir=os.path.join(scene_path, "depths_full"),
        train_list=read_list(train_list_file),
        test_list=read_list(test_list_file),
        device=device,
    )
