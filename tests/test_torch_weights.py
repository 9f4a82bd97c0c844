"""The port's checkpoint manifest, loader, CLI and conf registry against the
JAX package's.

Checkpoints are random weights at the official shapes, under the official
names and in the official formats (``weights.write_random``); each one
also loads through the JAX package's own converter, which checks the
format independently, and the two networks compute the same output.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import d2net as jd2
from gs_localization_tpu.sfm import dir as jdir
from gs_localization_tpu.sfm import disk as jdk
from gs_localization_tpu.sfm import eigenplaces as jep
from gs_localization_tpu.sfm import lightglue as jlg
from gs_localization_tpu.sfm import loftr as jlf
from gs_localization_tpu.sfm import openibl as joi
from gs_localization_tpu.sfm import r2d2 as jr2
from gs_localization_tpu.sfm import registry as jreg
from gs_localization_tpu.sfm import weights as jw
from gs_localization_torch.sfm import d2net as td2
from gs_localization_torch.sfm import dir as tdir
from gs_localization_torch.sfm import disk as tdk
from gs_localization_torch.sfm import eigenplaces as tep
from gs_localization_torch.sfm import lightglue as tlg
from gs_localization_torch.sfm import loftr as tlf
from gs_localization_torch.sfm import openibl as toi
from gs_localization_torch.sfm import r2d2 as tr2
from gs_localization_torch.sfm import registry as treg
from gs_localization_torch.sfm import weights as tw
from gs_localization_torch.sfm.features import Features, rgb_to_gray
from gs_localization_torch.sfm.superpoint import extract_superpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the rows of the LightGlue, LoFTR, D2-Net, R2D2, DISK, DIR, OpenIBL and
# EigenPlaces networks
NEW_ROWS = ("lightglue", "loftr_outdoor", "d2net", "r2d2", "disk", "dir",
            "openibl", "eigenplaces")


@pytest.fixture(scope="module")
def wdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    for name in ("superpoint", "superglue_outdoor"):
        tw.write_random(name, str(d), seed=0)
    return str(d)


def test_manifest_equals_jax():
    assert list(tw.MANIFEST) == list(jw.MANIFEST)
    for name, spec in tw.MANIFEST.items():
        js = jw.MANIFEST[name]
        assert (spec.file, spec.source, spec.note) == \
            (js.file, js.source, js.note), name


def test_load_by_path_and_env(wdir, monkeypatch):
    path = os.path.join(wdir, "superpoint_v1.pth")
    net = tw.load("superpoint", path, device="cpu")
    assert not net.training and net.conv1a.weight.shape == (64, 1, 3, 3)
    assert tw.n_params(net) == 1_300_865
    monkeypatch.setenv("GSLOC_WEIGHTS_DIR", wdir)
    net2 = tw.load("superpoint", device="cpu")
    torch.testing.assert_close(net.convDb.bias, net2.convDb.bias,
                               rtol=0, atol=0)
    # the JAX package's converter reads the same file to the same weights
    jp = jw.load("superpoint", path)
    np.testing.assert_array_equal(
        np.asarray(jp["conv1a"]["kernel"]).transpose(3, 2, 0, 1),
        net.conv1a.weight.numpy())
    sg = tw.load("superglue_outdoor", device="cpu")
    jsg = jw.load("superglue_outdoor")
    np.testing.assert_array_equal(np.asarray(jsg["final_proj"]["w"]).T,
                                  sg.final_proj.weight[:, :, 0].numpy())


def test_load_missing_names_file_and_doc(monkeypatch, tmp_path):
    monkeypatch.setenv("GSLOC_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError) as e:
        tw.load("superglue_outdoor", device="cpu")
    msg = str(e.value)
    assert "superglue_outdoor.pth" in msg and "WEIGHTS.md" in msg
    monkeypatch.delenv("GSLOC_WEIGHTS_DIR")
    with pytest.raises(FileNotFoundError, match="GSLOC_WEIGHTS_DIR unset"):
        tw.load("superpoint", device="cpu")


def test_check_dir_statuses(wdir, tmp_path):
    out = tw.check_dir(wdir, device="cpu")
    assert out["superpoint"].startswith("ok (1,300,865 params, sha256 ")
    assert out["superglue_outdoor"].startswith("ok (")
    assert out["netvlad"] == "missing" and out["dpt_hybrid"] == "missing"
    # corrupt files: FAILED, and the sweep goes on
    (tmp_path / tw.MANIFEST["superpoint"].file).write_bytes(b"not a file")
    (tmp_path / tw.MANIFEST["r2d2"].file).write_bytes(b"")
    out2 = tw.check_dir(str(tmp_path), device="cpu")
    assert out2["superpoint"].startswith("FAILED: RuntimeError")
    assert out2["r2d2"].startswith("FAILED: RuntimeError")
    assert out2["superglue_outdoor"] == "missing"


def test_cli_check_and_list(wdir, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "gs_localization_torch.sfm.weights",
         "--check", wdir, "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]
    assert "superpoint" in r.stdout and "ok (" in r.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", "gs_localization_torch.sfm.weights",
         "--list"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0
    assert "dpt_hybrid-midas-501f0c75.pt" in r2.stdout
    assert len(r2.stdout.splitlines()) == len(tw.MANIFEST)
    (tmp_path / tw.MANIFEST["disk"].file).write_bytes(b"")
    r3 = subprocess.run(
        [sys.executable, "-m", "gs_localization_torch.sfm.weights",
         "--check", str(tmp_path), "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r3.returncode == 1 and "FAILED" in r3.stdout


def test_registry_tables_equal_jax():
    for t, j in ((treg.EXTRACTOR_CONFS, jreg.EXTRACTOR_CONFS),
                 (treg.MATCHER_CONFS, jreg.MATCHER_CONFS),
                 (treg.RETRIEVAL_CONFS, jreg.RETRIEVAL_CONFS),
                 (treg.DENSE_CONFS, jreg.DENSE_CONFS)):
        assert t == j


def test_registry_serves_the_networks(wdir):
    """superpoint_aachen through the registry is extract_superpoint at
    4,096 keypoints, NMS 3; the classical confs need no weights; the NN
    and SuperGlue matchers take Features."""
    sp = tw.load("superpoint", os.path.join(wdir, "superpoint_v1.pth"),
                 device="cpu")
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)
    f = treg.get_extractor("superpoint_aachen", params=sp)(img)
    ref = extract_superpoint(sp, rgb_to_gray(torch.tensor(img)), 4096, 3)
    for a, b in zip(f[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a loaded network"):
        treg.get_extractor("superpoint_max")
    h = treg.get_extractor("harris", device="cpu", num_keypoints=64)(img)
    assert h.keypoints.shape == (64, 2)
    f2 = treg.get_extractor("superpoint_aachen", params=sp,
                            num_keypoints=64)(np.roll(img, 3, axis=1))
    f1 = treg.get_extractor("superpoint_aachen", params=sp,
                            num_keypoints=64)(img)
    m = treg.get_matcher("NN-mutual")(f1, f2)
    assert m.matches0.shape == (64,)
    sg = tw.load("superglue_outdoor",
                 os.path.join(wdir, "superglue_outdoor.pth"), device="cpu")
    r = treg.get_matcher("superglue-fast", params=sg)(f1, f2, (80, 64),
                                                      (80, 64))
    assert r.matches0.shape == (64,) and r.matches1.shape == (64,)
    d = treg.get_global_descriptor("tiny", device="cpu")(img)
    assert d.shape == (256,)


def _img(seed, h, w, c=3):
    shape = (h, w, c) if c else (h, w)
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _kpts(seed, n):
    rng = np.random.default_rng(seed)
    k = rng.uniform(0, 480, (n, 2)).astype(np.float32)
    d = rng.standard_normal((n, 256)).astype(np.float32)
    return k, d / np.linalg.norm(d, axis=1, keepdims=True)


def _same_features(ft, fj, atol):
    np.testing.assert_array_equal(ft.keypoints.numpy() > -1,
                                  np.asarray(fj.keypoints) > -1)
    for a, b in zip(ft[:3], fj[:3]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=atol * max(np.abs(b).max(), 1.0))


def _lightglue(tnet, jp):
    k0, d0 = _kpts(1, 96)
    k1, d1 = _kpts(2, 80)
    rt = tlg.lightglue_match(tnet, *map(torch.tensor, (k0, d0, k1, d1)),
                             640, 480, 640, 480, match_threshold=0.0)
    rj = jlg.lightglue_match(jp, k0, d0, k1, d1, 640, 480, 640, 480,
                             match_threshold=0.0)
    np.testing.assert_array_equal(rt.matches0.numpy(),
                                  np.asarray(rj.matches0))
    np.testing.assert_allclose(rt.matching_scores0.numpy(),
                               np.asarray(rj.matching_scores0), atol=1e-4)


def _loftr(tnet, jp):
    img0 = _img(3, 64, 96, 0)
    img1 = np.roll(img0, 8, axis=1)
    mt = tlf.loftr_match(tnet, torch.tensor(img0), torch.tensor(img1),
                         max_matches=32, match_threshold=0.0)
    mj = jlf.loftr_match(jp, jnp.asarray(img0), jnp.asarray(img1),
                         max_matches=32, match_threshold=0.0)
    np.testing.assert_array_equal(mt.kpts1.numpy(), np.asarray(mj.kpts1))
    np.testing.assert_allclose(mt.kpts0.numpy(), np.asarray(mj.kpts0),
                               atol=1e-5 * 96)
    np.testing.assert_allclose(mt.scores.numpy(), np.asarray(mj.scores),
                               atol=1e-4)


def _extractor(textract, jextract, atol, **kw):
    def run(tnet, jp):
        img = _img(4, 64, 96)
        _same_features(textract(tnet, torch.tensor(img), **kw),
                       jextract(jp, jnp.asarray(img), **kw), atol)
    return run


def _descriptor(tfn, jfn, hw):
    def run(tnet, jp):
        img = _img(5, *hw)
        dj = np.asarray(jax.jit(lambda im: jfn(jp, im))(img))
        dt = tfn(tnet, torch.tensor(img)).numpy()
        np.testing.assert_allclose(dt, dj, rtol=0,
                                   atol=1e-5 * np.abs(dj).max())
    return run


# name -> the output both packages' networks compute, held equal; tolerances
# as in each module's test file
SAME_OUTPUT = {
    "lightglue": _lightglue,
    "loftr_outdoor": _loftr,
    "d2net": _extractor(td2.extract_d2net, jd2.extract_d2net, 1e-5,
                        num_keypoints=128),
    "r2d2": _extractor(tr2.extract_r2d2, jr2.extract_r2d2, 1e-5,
                       num_keypoints=128),
    "disk": _extractor(tdk.extract_disk, jdk.extract_disk, 1e-5,
                       num_keypoints=128),
    "dir": _descriptor(tdir.dir_descriptor, jdir.dir_descriptor, (64, 64)),
    "openibl": _descriptor(toi.openibl_descriptor, joi.openibl_descriptor,
                           (64, 64)),
    "eigenplaces": _descriptor(tep.eigenplaces_descriptor,
                               jep.eigenplaces_descriptor, (64, 64)),
}


@pytest.mark.parametrize("name", NEW_ROWS)
def test_written_row_loads_in_both_packages(name, tmp_path):
    """write_random writes the row's file in the layout both packages'
    ``load`` read (the official name, format and key names); the port's
    network and the JAX package's params of the same file compute the
    same output, on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = tw.write_random(name, str(tmp_path), seed=0)
        assert os.path.basename(path) == tw.MANIFEST[name].file
        net = tw.load(name, path, device="cpu")
        assert not net.training and tw.n_params(net) > 0
        SAME_OUTPUT[name](net, jw.load(name, path))
        assert tw.check_dir(str(tmp_path), device="cpu")[name].startswith(
            "ok (")
    finally:
        torch.set_num_threads(n)


def _conf_nets():
    """Port networks at PyTorch's default initialisation, small where the
    module allows (resnet18 for DIR and EigenPlaces)."""
    torch.manual_seed(0)
    return {"r2d2": tr2.R2D2Net("cpu"), "d2net": td2.D2Net("cpu"),
            "disk": tdk.DiskNet("cpu"), "lightglue": tlg.LightGlueNet("cpu"),
            "loftr": tlf.LoFTRNet("cpu"),
            "dir": tdir.DirNet("resnet18", 64, "cpu"),
            "openibl": toi.OpenIBLNet("cpu"),
            "eigenplaces": tep.EigenPlacesNet("resnet18", 64, "cpu")}


def _check_extractor(conf, net, fn, **kw):
    img = _img(6, 48, 64)
    f = treg.get_extractor(conf, params=net, num_keypoints=64)(img)
    ref = fn(net, torch.tensor(img), num_keypoints=64, **kw)
    return list(f[:3]), list(ref[:3])


def _check_matcher(conf, net):
    (k0, d0), (k1, d1) = _kpts(7, 40), _kpts(8, 36)
    f0 = Features(torch.tensor(k0), torch.ones(40), torch.tensor(d0))
    f1 = Features(torch.tensor(k1), torch.ones(36), torch.tensor(d1))
    r = treg.get_matcher(conf, params=net)(f0, f1, (640, 480), (640, 480))
    ref = tlg.lightglue_match(net, f0.keypoints, f0.descriptors,
                              f1.keypoints, f1.descriptors, 640, 480, 640,
                              480)
    return list(r), list(ref)


def _check_dense(conf, net):
    img0 = _img(9, 192, 256)
    img1 = np.roll(img0, 8, axis=1)
    matcher, cfg = treg.get_dense_matcher(conf, params=net)
    assert cfg == {"max_error": 1.0, "cell_size": 1.0}
    ref = tlf.loftr_match(net, *[rgb_to_gray(torch.tensor(im))
                                 for im in (img0, img1)])
    return list(matcher(img0, img1)), list(ref)


def _check_descriptor(conf, net, fn):
    img = _img(10, 64, 64)
    return ([treg.get_global_descriptor(conf, params=net)(img)],
            [fn(net, torch.tensor(img))])


@pytest.mark.parametrize("conf", [
    "r2d2", "d2net-ss", "disk", "lightglue", "superpoint+lightglue",
    "loftr", "dir", "openibl", "eigenplaces"])
def test_registry_serves_each_conf(conf):
    """Each conf of the network kinds beyond SuperPoint, SuperGlue and
    NetVLAD is served and equals its module function on the same inputs,
    bit for bit; without a network it asks for one."""
    nets = _conf_nets()
    checks = {
        "r2d2": lambda: _check_extractor("r2d2", nets["r2d2"],
                                         tr2.extract_r2d2),
        "d2net-ss": lambda: _check_extractor("d2net-ss", nets["d2net"],
                                             td2.extract_d2net),
        "disk": lambda: _check_extractor("disk", nets["disk"],
                                         tdk.extract_disk, window_size=5),
        "lightglue": lambda: _check_matcher("lightglue", nets["lightglue"]),
        "superpoint+lightglue": lambda: _check_matcher(
            "superpoint+lightglue", nets["lightglue"]),
        "loftr": lambda: _check_dense("loftr", nets["loftr"]),
        "dir": lambda: _check_descriptor("dir", nets["dir"],
                                         tdir.dir_descriptor),
        "openibl": lambda: _check_descriptor("openibl", nets["openibl"],
                                             toi.openibl_descriptor),
        "eigenplaces": lambda: _check_descriptor(
            "eigenplaces", nets["eigenplaces"], tep.eigenplaces_descriptor),
    }
    got, ref = checks[conf]()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    getter = (treg.get_extractor if conf in treg.EXTRACTOR_CONFS else
              treg.get_matcher if conf in treg.MATCHER_CONFS else
              treg.get_dense_matcher if conf in treg.DENSE_CONFS else
              treg.get_global_descriptor)
    with pytest.raises(ValueError, match="needs a loaded network"):
        getter(conf)
