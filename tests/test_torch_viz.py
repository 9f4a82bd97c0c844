"""``gs_localization_torch.sfm.viz`` against the JAX package's
``sfm/viz.py``: the cases of tests/test_viz.py through the port (each a
non-trivial PNG), and what each draws equal to what JAX's draws on the
same inputs: scatter offsets and colours, line segments and colours, 3D
lines and texts (the port takes torch tensors where JAX takes arrays).
CPU only: the card machine has no matplotlib."""

import numpy as np
import pytest
import torch

from gs_localization_tpu.data import colmap as jcolmap
from gs_localization_tpu.sfm import viz as jviz
from gs_localization_torch.core.gaussians import GaussianParams
from gs_localization_torch.data import colmap as tcolmap
from gs_localization_torch.sfm import viz
from helpers import random_scene

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "live")


def _model(lib):
    rng = np.random.default_rng(0)
    cams = {1: lib.ColmapCamera(1, "PINHOLE", 64, 48,
                                np.array([60.0, 60.0, 32.0, 24.0]))}
    xyz = rng.uniform([-1, -1, 3], [1, 1, 6], (30, 3))
    pts = {j: lib.ColmapPoint3D(j, xyz[j], np.array([200, 100, 50]), 0.5,
                                np.array([1, 2]), np.array([j, j]))
           for j in range(30)}
    images = {}
    for i, name in [(1, "a.png"), (2, "b.png")]:
        xys = (xyz[:, :2] / xyz[:, 2:3]) * 60.0 + np.array([32.0, 24.0])
        p3ids = np.where(np.arange(30) % 3 == 0, -1, np.arange(30))
        images[i] = lib.ColmapImage(i, np.array([1.0, 0, 0, 0]),
                                    np.array([0.1 * i, 0.0, 0.0]), 1, name,
                                    xys, p3ids)
    return cams, images, pts


def _img(h=48, w=64):
    return np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _check_png(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 800


def _drawn(fig):
    """What a figure draws, as arrays: per axes its collections' offsets
    (3D: their 3D offsets) and face colours, its lines' data and its
    texts; then the figure's own artists' segments and colours."""
    out = []
    for ax in fig.axes:
        for c in ax.collections:
            off = getattr(c, "_offsets3d", None)
            out.append(np.asarray(off if off is not None else c.get_offsets(),
                                  np.float64))
            out.append(np.asarray(c.get_facecolors(), np.float64))
        for ln in ax.lines:
            out.append(np.asarray(ln.get_data_3d() if hasattr(
                ln, "get_data_3d") else ln.get_xydata(), np.float64))
        out.append(np.array([hash(t.get_text()) for t in ax.texts]))
    for a in fig.artists:
        out.append(np.asarray(a.get_segments(), np.float64))
        out.append(np.asarray(a.get_colors(), np.float64))
    return out


def _same_drawing(fig_t, fig_j):
    dt, dj = _drawn(fig_t), _drawn(fig_j)
    assert len(dt) == len(dj) and len(dt) > 0
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def _kp():
    return np.random.default_rng(0).uniform(0, 40, (25, 2))


def test_plot_images_keypoints_matches(tmp_path):
    figs = []
    for lib, conv in ((viz, torch.tensor), (jviz, np.asarray)):
        kp0 = conv(_kp())
        kp1 = kp0 + 2.0
        fig, axes = lib.plot_images([conv(_img()), conv(_img())],
                                    titles=["q", "d"])
        lib.plot_keypoints(axes, [kp0, kp1], colors="lime")
        lib.plot_matches(fig, axes[0], axes[1], kp0, kp1,
                         color=lib.error_colormap(conv(np.linspace(0, 1, 25))))
        lib.add_text(axes[0], "hello")
        figs.append(fig)
    _same_drawing(*figs)
    out = tmp_path / "m.png"
    viz.save_plot(figs[0], out)
    jviz.save_plot(figs[1], tmp_path / "j.png")
    _check_png(out)


def test_error_colormap_endpoints():
    c = viz.error_colormap(torch.tensor([0.0, 0.5, 1.0]))
    np.testing.assert_allclose(c[0], [1, 0, 0], atol=1e-6)   # red
    np.testing.assert_allclose(c[1], [1, 1, 0], atol=1e-6)   # yellow
    np.testing.assert_allclose(c[2], [0, 1, 0], atol=1e-6)   # green
    x = np.linspace(-0.5, 1.5, 41)
    np.testing.assert_array_equal(viz.error_colormap(x),
                                  jviz.error_colormap(x))


@pytest.mark.parametrize("mode", ["visibility", "track_length", "depth"])
def test_visualize_sfm_2d_modes(tmp_path, mode):
    image_of = {"a.png": _img(), "b.png": _img()}
    figs = viz.visualize_sfm_2d(_model(tcolmap), image_of, color_by=mode,
                                selected=["a.png"])
    figs_j = jviz.visualize_sfm_2d(_model(jcolmap), image_of, color_by=mode,
                                   selected=["a.png"])
    assert len(figs) == 1
    _same_drawing(figs[0], figs_j[0])
    out = tmp_path / f"{mode}.png"
    viz.save_plot(figs[0], out)
    jviz.save_plot(figs_j[0], tmp_path / "j.png")
    _check_png(out)


def test_visualize_loc(tmp_path):
    kp = np.random.default_rng(2).uniform(0, 40, (30, 2))
    inl = np.arange(30) % 2 == 0
    fig = viz.visualize_loc(_img(), torch.tensor(_img()), torch.tensor(kp),
                            kp + 1.0, inliers=torch.tensor(inl),
                            query_name="q.png", db_name="t.png")
    fig_j = jviz.visualize_loc(_img(), _img(), kp, kp + 1.0, inliers=inl,
                               query_name="q.png", db_name="t.png")
    _same_drawing(fig, fig_j)
    out = tmp_path / "loc.png"
    viz.save_plot(fig, out)
    jviz.save_plot(fig_j, tmp_path / "j.png")
    _check_png(out)


def test_reconstruction_3d(tmp_path):
    fig, ax = viz.init_figure_3d(height=4.0)
    viz.plot_reconstruction_3d(ax, _model(tcolmap), min_track_length=1)
    fig_j, ax_j = jviz.init_figure_3d(height=4.0)
    jviz.plot_reconstruction_3d(ax_j, _model(jcolmap), min_track_length=1)
    _same_drawing(fig, fig_j)
    K = np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]])
    np.testing.assert_allclose(
        viz.frustum_corners(torch.eye(3), torch.tensor([0.1, 0, 0]),
                            torch.tensor(K)),
        jviz.frustum_corners(np.eye(3), np.array([0.1, 0, 0]), K), rtol=1e-6)
    out = tmp_path / "rec3d.png"
    viz.save_plot(fig, out)
    jviz.save_plot(fig_j, tmp_path / "j.png")
    _check_png(out)


def test_gaussian_map_3d(tmp_path):
    g = random_scene(np.random.default_rng(0), n=200, sh_degree=1)
    tg = GaussianParams.from_numpy({f: np.asarray(getattr(g, f))
                                    for f in FIELDS}, 1, 1, device="cpu")
    fig, ax = viz.init_figure_3d(height=4.0)
    viz.plot_gaussian_map_3d(ax, tg, max_points=100)
    fig_j, ax_j = jviz.init_figure_3d(height=4.0)
    jviz.plot_gaussian_map_3d(ax_j, g, max_points=100)
    _same_drawing(fig, fig_j)
    out = tmp_path / "map3d.png"
    viz.save_plot(fig, out)
    jviz.save_plot(fig_j, tmp_path / "j.png")
    _check_png(out)
