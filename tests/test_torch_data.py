"""The port's data and I/O layer against the JAX package's on the same
files: COLMAP models (text and binary, written by one package and read by
the other), scene loading and its splits, the 7-Scenes, Cambridge and LLFF
prepare stages, pose-results files and ``rotmat_to_quat``."""

import os
import struct

import numpy as np
import pytest

from gs_localization_tpu.core.camera import rotmat_to_quat as j_r2q
from gs_localization_tpu.data import colmap as jcol
from gs_localization_tpu.data import prepare as jprep
from gs_localization_tpu.data import scene as jscene
from gs_localization_tpu.data import seven_scenes as jseven
from gs_localization_tpu.pipelines.localize import (
    init_camera_from_results as j_init_camera)
from gs_localization_tpu.sfm import io as jio
from gs_localization_torch.core.camera import rotmat_to_quat as t_r2q
from gs_localization_torch.data import colmap as tcol
from gs_localization_torch.data import prepare as tprep
from gs_localization_torch.data import scene as tscene
from gs_localization_torch.data import seven_scenes as tseven
from gs_localization_torch.pipelines.localize import (
    init_camera_from_results as t_init_camera)
from gs_localization_torch.sfm import io as tio
from torch_bridge import np_of


def _model(col, n_images=10, seed=0):
    """cameras, images and points of a small model, built with ``col``'s
    types: two camera models, random unit quaternions, one image with 2D
    points, one point with a track."""
    rng = np.random.default_rng(seed)
    cams = {1: col.ColmapCamera(1, "PINHOLE", 64, 48,
                                np.array([60.0, 61.0, 32.5, 24.25])),
            2: col.ColmapCamera(2, "SIMPLE_RADIAL", 64, 48,
                                np.array([58.0, 31.0, 23.5, 0.01]))}
    images = {}
    for i in range(1, n_images + 1):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        xys = rng.uniform(0, 60, (3, 2)) if i == 1 else np.zeros((0, 2))
        ids = np.array([7, -1, 7], np.int64) if i == 1 else \
            np.zeros((0,), np.int64)
        images[i] = col.ColmapImage(i, q, rng.uniform(-1, 1, 3),
                                    1 + i % 2, f"seq-01-im{i:02d}-color.png",
                                    xys, ids)
    pts = {7: col.ColmapPoint3D(7, rng.uniform(-1, 1, 3),
                                np.array([255, 128, 0], np.uint8), 0.75,
                                np.array([1, 1]), np.array([0, 2])),
           9: col.ColmapPoint3D(9, rng.uniform(-1, 1, 3),
                                np.array([1, 2, 3], np.uint8), 0.5,
                                np.array([], int), np.array([], int))}
    return cams, images, pts


def _write_binary(path, cams, images, pts) -> None:
    """The three .bin files of a model, per the COLMAP spec."""
    ids = {name: mid for mid, (name, _) in jcol.CAMERA_MODELS.items()}
    with open(os.path.join(path, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, ids[c.model], c.width,
                                c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))
    with open(os.path.join(path, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, pid))
    with open(os.path.join(path, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz, *p.rgb, p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for a, b in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", a, b))


def _same_model(a, b) -> None:
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert sorted(ca) == sorted(cb) and sorted(ia) == sorted(ib) \
        and sorted(pa) == sorted(pb)
    for k in ca:
        assert (ca[k].id, ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].id, cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
        assert (ca[k].fx, ca[k].fy, ca[k].cx, ca[k].cy) == \
            (cb[k].fx, cb[k].fy, cb[k].cx, cb[k].cy)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == \
            (ib[k].id, ib[k].camera_id, ib[k].name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f),
                                          getattr(ib[k], f), err_msg=f)
    for k in pa:
        assert pa[k].error == pb[k].error
        for f in ("xyz", "rgb", "image_ids", "point2d_idxs"):
            np.testing.assert_array_equal(getattr(pa[k], f),
                                          getattr(pb[k], f), err_msg=f)


@pytest.mark.parametrize("encoding", ["text", "binary"])
def test_colmap_models_read_across_packages(tmp_path, encoding):
    for writer, wcol, reader in ((jcol, jcol, tcol), (tcol, tcol, jcol)):
        model = _model(wcol)
        path = str(tmp_path / f"{encoding}_{writer.__name__}")
        os.makedirs(path)
        if encoding == "text":
            writer.write_colmap_model_text(path, *model)
        else:
            _write_binary(path, *model)
        got = reader.read_colmap_model(path)
        _same_model(got, writer.read_colmap_model(path))
        _same_model(got, model)
    im_j = jcol.read_colmap_model(path)[1][1]
    im_t = tcol.read_colmap_model(path)[1][1]
    np.testing.assert_allclose(im_t.rotmat(), im_j.rotmat(), atol=1e-6)


def _same_scene(sj, st, root_j=None, root_t=None) -> None:
    """Names, splits, paths (under their roots), points exactly; w2c and
    intrinsics within 1e-6; the same extent."""
    def rel(p, root):
        return p if p is None or root is None else os.path.relpath(p, root)

    for cj, ct in ((sj.train_cameras, st.train_cameras),
                   (sj.test_cameras, st.test_cameras)):
        assert [c.name for c in cj] == [c.name for c in ct]
        assert [c.uid for c in cj] == [c.uid for c in ct]
        for a, b in zip(cj, ct):
            assert rel(a.image_path, root_j) == rel(b.image_path, root_t)
            assert rel(a.depth_path, root_j) == rel(b.depth_path, root_t)
            assert (a.camera.width, a.camera.height) == \
                (b.camera.width, b.camera.height)
            assert b.camera.device.type == "cpu"
            for f in ("w2c", "fx", "fy", "cx", "cy"):
                np.testing.assert_allclose(np_of(getattr(b.camera, f)),
                                           np_of(getattr(a.camera, f)),
                                           atol=1e-6, rtol=0, err_msg=f)
    np.testing.assert_array_equal(st.points, sj.points)
    np.testing.assert_array_equal(st.colors, sj.colors)
    np.testing.assert_allclose(st.extent, sj.extent, rtol=1e-6)


@pytest.mark.parametrize("split", ["llffhold", "lists", "all"])
def test_load_colmap_scene_matches_jax(tmp_path, split):
    model = _model(jcol, n_images=11)
    path = str(tmp_path / "model")
    jcol.write_colmap_model_text(path, *model)
    names = [im.name for im in model[1].values()]
    kw = dict(images_dir="/data/images", depths_dir="/data/depths")
    if split == "llffhold":
        kw.update(eval_split=True, llffhold=4)
    elif split == "lists":
        kw.update(train_list=names[:5], test_list=names[7:])
    sj = jscene.load_colmap_scene(path, **kw)
    st = tscene.load_colmap_scene(path, device="cpu", **kw)
    _same_scene(sj, st)
    assert st.test_cameras or split == "all"
    assert st.train_cameras[0].depth_path.endswith("-depth.png")


def _seven_scenes_raw(root) -> None:
    for seq, n in (("seq-01", 3), ("seq-02", 2), ("seq-03", 1)):
        d = root / seq
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"frame-{i:06d}.color.png").write_bytes(b"c%d" % i)
            (d / f"frame-{i:06d}.depth.png").write_bytes(b"d%d" % i)
            (d / f"frame-{i:06d}.pose.txt").write_text("1 0 0 0\n")
    (root / "TrainSplit.txt").write_text("sequence1\nsequence3\n")
    (root / "TestSplit.txt").write_text("sequence2\n")


def _listing(root):
    """Every file under root: relative path -> link target or bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = (
                os.readlink(p) if os.path.islink(p) else open(p, "rb").read())
    return out


def test_seven_scenes_prepare_and_load_match_jax(tmp_path):
    raw = tmp_path / "chess"
    _seven_scenes_raw(raw)
    out_j, out_t = str(tmp_path / "out_j"), str(tmp_path / "out_t")
    split_j = jseven.prepare_scene(str(raw), out_j)
    split_t = tseven.prepare_scene(str(raw), out_t)
    assert split_t == split_j
    assert [len(s) for s in split_t] == [4, 2]
    assert _listing(out_t) == _listing(out_j)
    assert tseven.flat_name("seq-01", "frame-000001.color.png") == \
        jseven.flat_name("seq-01", "frame-000001.color.png")
    for line in ("sequence4", "sequence12", "seq"):
        assert tseven.seq_dir_from_split_line(line) == \
            jseven.seq_dir_from_split_line(line)
    # a ground-truth model with the raw names, flattened by each package
    cams, images, pts = _model(jcol, n_images=6)
    raw_names = [f"seq-0{s}/frame-{i:06d}.color.png"
                 for s, i in ((1, 0), (1, 1), (1, 2), (2, 0), (2, 1),
                              (3, 0))]
    images = {k: im._replace(name=n)
              for (k, im), n in zip(images.items(), raw_names)}
    for out, pkg in ((out_j, jseven), (out_t, tseven)):
        model = os.path.join(out, "sparse_dslam", "0")
        jcol.write_colmap_model_text(model, cams, images, pts)
        pkg.flatten_colmap_image_names(os.path.join(model, "images.txt"))
    assert _listing(out_t) == _listing(out_j)
    sj = jseven.load_seven_scenes_scene(out_j)
    st = tseven.load_seven_scenes_scene(out_t, device="cpu")
    _same_scene(sj, st, out_j, out_t)
    assert len(st.train_cameras) == 4 and len(st.test_cameras) == 2


def _png(path, w, h, seed) -> None:
    from PIL import Image

    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(path)


def _cambridge_raw(root) -> None:
    for seq in ("seq1", "seq4"):
        (root / seq).mkdir(parents=True)
    train = ["seq1/frame00001.png", "seq1/frame00002.png"]
    test = ["seq4/frame00001.png", "seq4/missing.png"]
    for i, n in enumerate(train + test[:1]):
        _png(root / n, 96, 54, i)
    with open(root / "dataset_train.txt", "w") as f:
        f.write("Visual Landmark Dataset\nImageFile, Camera Position\n\n")
        f.write("".join(f"{n} 0 0 0 1 0 0 0\n" for n in train))
    (root / "dataset_test.txt").write_text(
        "".join(f"{n} 0 0 0 1 0 0 0\n" for n in test))
    cams = {1: jcol.ColmapCamera(1, "PINHOLE", 1920, 1080,
                                 np.array([1600.0, 1610.0, 960.0, 540.0]))}
    _, images, pts = _model(jcol, n_images=2)
    images = {k: im._replace(name=n, camera_id=1)
              for (k, im), n in zip(images.items(), train)}
    jcol.write_colmap_model_text(str(root / "model_train"), cams, images,
                                 pts)
    extra = root.parent / "additional"
    extra.mkdir()
    _png(extra / "seq1_frame00001.depth.png", 8, 8, 9)


def test_prepare_cambridge_matches_jax(tmp_path):
    raw = tmp_path / "KingsCollege"
    _cambridge_raw(raw)
    extra = str(tmp_path / "additional")
    out_j, out_t = str(tmp_path / "out_j"), str(tmp_path / "out_t")
    split_j = jprep.prepare_cambridge(str(raw), out_j, depth_dir=extra,
                                      size=(64, 36))
    split_t = tprep.prepare_cambridge(str(raw), out_t, depth_dir=extra,
                                      size=(64, 36))
    assert split_t == split_j == (["seq1_frame00001.png",
                                   "seq1_frame00002.png"],
                                  ["seq4_frame00001.png"])
    assert _listing(out_t) == _listing(out_j)
    _same_model(tcol.read_colmap_model(os.path.join(out_t, "sparse/0")),
                jcol.read_colmap_model(os.path.join(out_j, "sparse/0")))
    kw = dict(train_list=split_j[0], test_list=split_j[1])
    _same_scene(jscene.load_colmap_scene(
                    os.path.join(out_j, "sparse/0"),
                    images_dir=os.path.join(out_j, "images_full"), **kw),
                tscene.load_colmap_scene(
                    os.path.join(out_t, "sparse/0"),
                    images_dir=os.path.join(out_t, "images_full"),
                    device="cpu", **kw), out_j, out_t)


def _llff_raw(root) -> None:
    (root / "images_4").mkdir(parents=True)
    cams = {1: jcol.ColmapCamera(1, "SIMPLE_RADIAL", 128, 72,
                                 np.array([100.0, 64.0, 36.0, 0.01]))}
    _, images, pts = _model(jcol, n_images=12)
    names = [f"img{i:03d}.JPG" for i in range(12)]
    images = {k: im._replace(name=n, camera_id=1)
              for (k, im), n in zip(images.items(), names)}
    for i, n in enumerate(names):        # images_4 holds PNGs by stem
        _png(root / "images_4" / n.replace(".JPG", ".png"), 32, 18, i)
    jcol.write_colmap_model_text(str(root / "sparse/0"), cams, images, pts)


@pytest.mark.parametrize("kind", ["llff", "mip360"])
def test_prepare_llff_matches_jax(tmp_path, kind):
    fn = {"llff": "prepare_llff", "mip360": "prepare_360"}[kind]
    root_j, root_t = tmp_path / "j", tmp_path / "t"
    for r in (root_j, root_t):
        _llff_raw(r)
    split_j = getattr(jprep, fn)(str(root_j))
    split_t = getattr(tprep, fn)(str(root_t))
    assert split_t == split_j
    assert len(split_t[0]) == {"llff": 1, "mip360": 2}[kind]
    assert _listing(root_t / "train_views") == _listing(root_j / "train_views")
    sj = jprep.load_llff_scene(str(root_j))
    st = tprep.load_llff_scene(str(root_t), device="cpu")
    _same_scene(sj, st, str(root_j), str(root_t))
    assert st.train_cameras[0].camera.width == 32


def test_rescale_and_flatten_match_jax(tmp_path):
    for model, params in (("SIMPLE_RADIAL", [100.0, 64.0, 36.0, 0.01]),
                          ("PINHOLE", [100.0, 101.0, 64.0, 36.0]),
                          ("OPENCV", [100.0, 101.0, 64.0, 36.0, 0.1, 0.0,
                                      0.0, 0.0])):
        cj = jcol.ColmapCamera(1, model, 128, 72, np.array(params))
        ct = tcol.ColmapCamera(1, model, 128, 72, np.array(params))
        a, b = jprep.rescale_camera(cj, 50, 30), tprep.rescale_camera(ct,
                                                                      50, 30)
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    with pytest.raises(ValueError, match="unsupported"):
        tprep.rescale_camera(tcol.ColmapCamera(1, "FOV", 8, 8,
                                               np.ones(5)), 4, 4)
    src = str(tmp_path / "src")
    cams, images, pts = _model(jcol, n_images=3)
    images = {k: im._replace(name=f"seq{k}/f.png")
              for k, im in images.items()}
    jcol.write_colmap_model_text(src, cams, images, pts)
    jprep.flatten_model_names(src, str(tmp_path / "j"))
    tprep.flatten_model_names(src, str(tmp_path / "t"))
    assert _listing(tmp_path / "t") == _listing(tmp_path / "j")


def test_pose_results_and_query_lists_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    poses = {}
    for i in range(5):
        q = rng.standard_normal(4)
        poses[f"seq-02-frame-{i:06d}-color.png"] = (q / np.linalg.norm(q),
                                                    rng.standard_normal(3))
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jio.write_pose_results(pj, poses)
    tio.write_pose_results(pt, poses)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    name = next(iter(poses))
    cj = j_init_camera(name, jio.read_pose_results(pj), 50.0, 51.0, 32.0,
                       24.0, 64, 48)
    ct = t_init_camera(name, tio.read_pose_results(pt), 50.0, 51.0, 32.0,
                       24.0, 64, 48, device="cpu")
    assert (ct.width, ct.height) == (cj.width, cj.height)
    for f in ("w2c", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(np_of(getattr(ct, f)),
                                   np_of(getattr(cj, f)), atol=1e-6)
    for path in (pj, pt):
        back_t, back_j = tio.read_pose_results(path), jio.read_pose_results(
            path)
        assert list(back_t) == list(back_j) == list(poses)
        for name, (q, t) in poses.items():     # repr(float): bit for bit
            for a, b, c in zip(back_t[name], back_j[name], (q, t)):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, c)
    ql = tmp_path / "queries_with_intrinsics.txt"
    ql.write_text("# name model w h params\n"
                  "q1.png PINHOLE 1024 576 700.5 701.25 512 288\n\n"
                  "q2.png SIMPLE_RADIAL 640 480 500 320 240 0.01\n")
    lt = tio.read_query_list_with_intrinsics(str(ql))
    lj = jio.read_query_list_with_intrinsics(str(ql))
    assert [(q.name, q.model, q.width, q.height) for q in lt] == \
        [(q.name, q.model, q.width, q.height) for q in lj]
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(tio.intrinsics_matrix(a),
                                      jio.intrinsics_matrix(b))


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def test_rotmat_to_quat_matches_jax():
    """Random rotations and rotations at and near 180 degrees (each branch
    of the conversion, including the sign choice w >= 0): the same float64
    bits as the JAX package."""
    rng = np.random.default_rng(0)
    mats = [_rot(rng.standard_normal(3), rng.uniform(0, np.pi))
            for _ in range(50)]
    for axis in ([1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 1, 1],
                 rng.standard_normal(3)):
        for eps in (0.0, 1e-9, 1e-6, -1e-6):
            mats.append(_rot(axis, np.pi - eps))
    def branch(m):
        if np.trace(m) > 0:
            return 0
        if m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            return 1
        return 2 if m[1, 1] > m[2, 2] else 3

    for m in mats:
        qt, qj = t_r2q(m), j_r2q(m)
        np.testing.assert_array_equal(qt, qj)
        assert qt.dtype == np.float64 and qt[0] >= 0
    assert {branch(m) for m in mats} == {0, 1, 2, 3}
