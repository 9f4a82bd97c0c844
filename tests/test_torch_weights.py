"""The port's checkpoint manifest, loader, CLI and conf registry against the
JAX package's.

Checkpoints are random weights at the official shapes, under the official
names and in the official formats (``weights.write_random``); each one
also loads through the JAX package's own converter, which checks the
format independently.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gs_localization_tpu.sfm import registry as jreg
from gs_localization_tpu.sfm import weights as jw
from gs_localization_torch.sfm import registry as treg
from gs_localization_torch.sfm import weights as tw
from gs_localization_torch.sfm.features import rgb_to_gray
from gs_localization_torch.sfm.superpoint import extract_superpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("superpoint", "superglue_outdoor", "superglue_indoor", "netvlad",
          "dpt_hybrid", "midas_v21")


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
    # a corrupt file and a network that is not ported: FAILED, and the
    # sweep goes on
    (tmp_path / tw.MANIFEST["superpoint"].file).write_bytes(b"not a file")
    (tmp_path / tw.MANIFEST["r2d2"].file).write_bytes(b"")
    out2 = tw.check_dir(str(tmp_path), device="cpu")
    assert out2["superpoint"].startswith("FAILED: RuntimeError")
    assert out2["r2d2"].startswith("FAILED: NotImplementedError")
    assert "ROADMAP.md" in out2["r2d2"]
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


@pytest.mark.parametrize("name", [n for n in tw.MANIFEST if n not in PORTED])
def test_rows_still_to_port_raise(name, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tw.write_random(name, str(tmp_path))
    (tmp_path / tw.MANIFEST[name].file).write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 5"):
        tw.load(name, str(tmp_path / tw.MANIFEST[name].file), device="cpu")


def test_registry_tables_equal_jax():
    for t, j in ((treg.EXTRACTOR_CONFS, jreg.EXTRACTOR_CONFS),
                 (treg.MATCHER_CONFS, jreg.MATCHER_CONFS),
                 (treg.RETRIEVAL_CONFS, jreg.RETRIEVAL_CONFS),
                 (treg.DENSE_CONFS, jreg.DENSE_CONFS)):
        assert t == j


@pytest.mark.parametrize("getter,conf", [
    (treg.get_extractor, "r2d2"), (treg.get_extractor, "d2net-ss"),
    (treg.get_extractor, "disk"), (treg.get_matcher, "lightglue"),
    (treg.get_matcher, "superpoint+lightglue"),
    (treg.get_dense_matcher, "loftr"), (treg.get_global_descriptor, "dir"),
    (treg.get_global_descriptor, "openibl"),
    (treg.get_global_descriptor, "eigenplaces"),
])
def test_registry_kinds_still_to_port_raise(getter, conf):
    with pytest.raises(NotImplementedError, match="item 5"):
        getter(conf, params=object())


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
