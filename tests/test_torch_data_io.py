"""The port's data layer against the JAX package's: the Blender reader,
the COLMAP database (each package reads what the other wrote), image
undistortion, and the native image loader's decodes (against PIL and the
JAX package's binding of the same ``native/loader.cpp``)."""

import json
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.data import colmap_db as jdb
from gs_localization_tpu.data.blender import (
    load_blender_scene as j_load_blender_scene)
from gs_localization_tpu.data.native_loader import NativeLoader as JNative
from gs_localization_tpu.ops import undistort as jund
from gs_localization_torch.data import colmap_db as tdb
from gs_localization_torch.data import native_loader as tnl
from gs_localization_torch.data.blender import load_blender_scene
from gs_localization_torch.ops import undistort as tund
from torch_bridge import np_of


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file (see ``test_torch_loc.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- Blender / NeRF-synthetic ----------------------------------------------

def _frames(rng, n, prefix):
    frames = []
    for i in range(n):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        c2w = np.eye(4)
        c2w[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)],
                       [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)],
                       [2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)]]
        c2w[:3, 3] = rng.uniform(-4, 4, 3)
        name = f"./{prefix}/r_{i}" + (".png" if i % 2 else "")
        frames.append({"file_path": name,
                       "transform_matrix": c2w.tolist()})
    return frames


def test_blender_scene_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for split, n in (("train", 5), ("test", 3)):
        (tmp_path / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.69, "frames": _frames(rng, n, split)}))
    kw = dict(width=100, height=80, num_init_points=50, seed=3)
    sj = j_load_blender_scene(str(tmp_path), **kw)
    st = load_blender_scene(str(tmp_path), device="cpu", **kw)
    assert st.extent == pytest.approx(sj.extent, rel=1e-6)
    np.testing.assert_array_equal(st.points, sj.points)
    np.testing.assert_array_equal(st.colors, sj.colors)
    for cj, ct in ((sj.train_cameras, st.train_cameras),
                   (sj.test_cameras, st.test_cameras)):
        assert len(ct) == len(cj)
        for a, b in zip(cj, ct):
            assert (b.uid, b.name, b.image_path) == (a.uid, a.name,
                                                     a.image_path)
            np.testing.assert_allclose(np_of(b.camera.w2c),
                                       np.asarray(a.camera.w2c), atol=1e-6)
            for f in ("fx", "fy", "cx", "cy"):
                assert float(getattr(b.camera, f)) == \
                    float(getattr(a.camera, f))
    assert [c.uid for c in st.test_cameras] == [5, 6, 7]


# ---- COLMAP database ---------------------------------------------------------

def _write(mod, path, rng):
    db = mod.ColmapDatabase(str(path))
    cam = db.add_camera("OPENCV", 64, 48,
                        np.array([60, 61, 32, 24, 0.01, -0.02, 0.0, 0.0]))
    ids = [db.add_image(f"im{i}.png", cam, qvec=(1.0, 0.1 * i, 0, 0),
                        tvec=(i, 0.5, -1.0)) for i in range(3)]
    kps = [rng.uniform(0, 60, (5 + i, 2)).astype(np.float32)
           for i in range(3)]
    for i, kp in zip(ids, kps):
        db.add_keypoints(i, kp)
        db.add_descriptors(i, rng.integers(0, 256, (len(kp), 128)))
    m = np.array([[0, 1], [2, 0], [4, 3]], np.uint32)
    db.add_matches(ids[2], ids[0], m)          # reversed ids: the swap
    db.add_matches(ids[0], ids[1], m[:2])
    db.add_two_view_geometry(ids[1], ids[0], m[:2])
    db.close()
    return ids, kps, m


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_colmap_db_is_shared_with_jax(tmp_path, writer):
    mods = {"jax": jdb, "torch": tdb}
    ids, kps, m = _write(mods[writer], tmp_path / "db.db",
                         np.random.default_rng(1))
    reader = mods["torch" if writer == "jax" else "jax"]
    db = reader.ColmapDatabase(str(tmp_path / "db.db"))
    for i, kp in zip(ids, kps):
        np.testing.assert_allclose(db.read_keypoints(i), kp, atol=1e-6)
    np.testing.assert_array_equal(db.read_matches(ids[2], ids[0]), m)
    np.testing.assert_array_equal(db.read_matches(ids[0], ids[2]),
                                  m[:, ::-1])
    db.close()
    # byte for byte: every table's rows equal the other writer's
    _write(reader, tmp_path / "other.db", np.random.default_rng(1))
    a = tdb.ColmapDatabase(str(tmp_path / "db.db"))
    b = tdb.ColmapDatabase(str(tmp_path / "other.db"))
    for table in ("cameras", "images", "keypoints", "descriptors", "matches",
                  "two_view_geometries"):
        q = f"SELECT * FROM {table} ORDER BY 1"
        assert a.conn.execute(q).fetchall() == b.conn.execute(q).fetchall(), \
            table
    a.close()
    b.close()
    for pair in ((3, 7), (7, 3), (1, 2**31 - 2)):
        pid = tdb.pair_id_from_images(*pair)
        assert pid == jdb.pair_id_from_images(*pair)
        assert tdb.images_from_pair_id(pid) == jdb.images_from_pair_id(pid) \
            == (min(pair), max(pair))


# ---- undistortion --------------------------------------------------------------

@pytest.mark.parametrize("channels,dist", [
    (3, (0.1, -0.05, 0.002, -0.001, 0.01)),
    (None, (-0.2, 0.03)),                    # k1 k2 only, a grey image
    (3, (0.4, 0.0, 0.0, 0.0))])              # barrel: samples off the image
def test_undistort_matches_jax(channels, dist):
    rng = np.random.default_rng(2)
    shape = (40, 56) + ((channels,) if channels else ())
    img = rng.uniform(0, 1, shape).astype(np.float32)
    intr = (50.0, 52.0, 27.5, 19.0)
    oj = np.asarray(jund.undistort_image(jnp.asarray(img), *intr, dist))
    ot = np_of(tund.undistort_image(torch.tensor(img), *intr, dist))
    assert ot.shape == oj.shape == img.shape
    np.testing.assert_allclose(ot, oj, atol=1e-5)
    src = np_of(tund.undistort_map(56, 40, *intr, *dist, device="cpu"))
    np.testing.assert_allclose(
        src, np.asarray(jund.undistort_map(56, 40, *intr, *dist)),
        atol=1e-5)
    # at zero distortion the map is the identity and the image comes back
    same = np_of(tund.undistort_image(torch.tensor(img), *intr, ()))
    np.testing.assert_allclose(same, img, atol=1e-5)


# ---- native loader -------------------------------------------------------------

# build errors that mean the machine lacks the toolchain, not a fault
NO_TOOLCHAIN = r"g\+\+ not found|fatal error: (png|jpeglib)\.h"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """The JAX suite's images: an RGB PNG and JPEG, a 16-bit depth PNG
    holding the invalid value 65535."""
    from PIL import Image

    if not tnl.NativeLoader.available():
        why = tnl.build_error()
        if re.search(NO_TOOLCHAIN, why):
            pytest.skip(f"no compiler or image headers here: {why}")
        pytest.fail(f"the port's native loader did not build: {why}")
    # both bindings build the same native/loader.cpp with the same flags:
    # where the port's builds, the JAX package's must load too
    assert JNative.available(), (
        "native/libgsl_loader.so did not load though the port's build of "
        "the same source did (see conftest.py at the repository's root)")
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(d / "a.png")
    Image.fromarray(rgb).save(d / "a.jpg", quality=95)
    dep = rng.uniform(500, 5000, (48, 64)).astype(np.uint16)
    dep[0, 0] = 65535
    Image.fromarray(dep.astype(np.int32), mode="I").convert("I;16").save(
        d / "a_depth.png")
    return d, rgb, dep


def _decode(loader_cls, path, kind):
    loader = loader_cls(1)
    loader.submit(5, str(path), kind)
    tag, arr = loader.fetch()
    loader.close()
    assert tag == 5
    return arr


@pytest.mark.parametrize("name,kind", [("a.png", tnl.KIND_RGB),
                                       ("a.jpg", tnl.KIND_RGB),
                                       ("a_depth.png", tnl.KIND_DEPTH16)])
def test_native_loader_decodes_as_pil_and_jax(images, name, kind):
    from gs_localization_torch.data.scene import load_depth, load_image

    d, _, _ = images
    arr = _decode(tnl.NativeLoader, d / name, kind)
    np.testing.assert_array_equal(arr, _decode(JNative, d / name, kind))
    pil = load_depth(str(d / name)) if kind == tnl.KIND_DEPTH16 \
        else load_image(str(d / name))
    assert arr.shape == pil.shape and arr.dtype == np.float32
    np.testing.assert_allclose(arr, pil, atol=1e-6)
    assert str(tnl.library_path()).startswith(str(tnl.BUILD_DIR))


def test_native_loader_errors_and_prefetch(images):
    d, rgb, dep = images
    loader = tnl.NativeLoader(1)
    loader.submit(0, str(d / "nope.png"), tnl.KIND_RGB)
    with pytest.raises(IOError):
        loader.fetch()
    loader.close()
    pl = tnl.PrefetchingSceneLoader(n_threads=2)
    pl.request(0, str(d / "a.png"), str(d / "a_depth.png"))
    pl.request(1, str(d / "a.jpg"))
    img1, dep1 = pl.get(1)
    img0, dep0 = pl.get(0)
    assert img0.shape == img1.shape == (48, 64, 3) and dep1 is None
    np.testing.assert_allclose(img0 * 255, rgb, atol=1e-3)
    assert dep0[0, 0] == 0.0
    np.testing.assert_allclose(dep0.ravel()[1:],
                               dep.ravel()[1:].astype(np.float32) / 1000.0,
                               atol=1e-3)
    assert pl.get(0)[0] is img0                # cached
    # as train_map's image_loader: called with a CameraInfo
    info = SimpleNamespace(uid=2, image_path=str(d / "a.png"),
                           depth_path=str(d / "a_depth.png"))
    img2, dep2 = pl(info)
    np.testing.assert_array_equal(img2, img0)
    np.testing.assert_array_equal(dep2, dep0)
    with pytest.raises(KeyError):
        pl.get(9)
