"""Keypoint / match / reconstruction debug visualization.

Counterpart of the JAX package's ``sfm/viz.py`` (itself hloc's plotting
stack: hloc/visualization.py, hloc/utils/viz.py, hloc/utils/viz_3d.py)
on matplotlib only, 3D plots through mpl_toolkits' Axes3D:

- 2D primitives: ``plot_images`` / ``plot_keypoints`` / ``plot_matches`` /
  ``add_text`` / ``save_plot`` and the red->green inlier colormap
  ``error_colormap``. Match lines are ONE LineCollection in figure
  coordinates rather than one artist per match.
- SfM overlays: ``visualize_sfm_2d`` colours an image's keypoints by
  visibility / track length / depth over a COLMAP-style model triple
  (``data.colmap.read_colmap_model``).
- Localization overlays: ``visualize_loc``, query <-> retrieved-train
  matches with inliers green and outliers red.
- 3D: ``init_figure_3d`` / ``plot_points3d`` / ``frustum_corners`` /
  ``plot_camera_frustum`` / ``plot_reconstruction_3d`` /
  ``plot_gaussian_map_3d`` (a map's means coloured by their DC colour).

Array arguments may be numpy arrays or torch tensors on any device (read
through ``.cpu().numpy()``); ``plot_gaussian_map_3d`` takes the port's
``GaussianParams``. Everything draws on explicit matplotlib figures and
works headless under the Agg backend. matplotlib is imported by this
module only: the rest of the package does not need it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import matplotlib

matplotlib.use("Agg", force=False)  # headless-safe default; no-op if set
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402
import matplotlib.patheffects as path_effects  # noqa: E402


def _np(x, dtype=None) -> np.ndarray:
    """A numpy array of x: a torch tensor through ``.cpu().numpy()``."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# --------------------------------------------------------------- primitives
def error_colormap(x: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] to red (0) -> yellow (0.5) -> green (1) RGB."""
    x = np.clip(_np(x, np.float32), 0.0, 1.0)
    r = np.clip(2.0 - 2.0 * x, 0.0, 1.0)
    g = np.clip(2.0 * x, 0.0, 1.0)
    return np.stack([r, g, np.zeros_like(r)], axis=-1)


def plot_images(
    imgs: Sequence[np.ndarray],
    titles: Optional[Sequence[str]] = None,
    cmaps: Union[str, Sequence[str]] = "gray",
    dpi: int = 100,
    pad: float = 0.5,
    adaptive: bool = True,
    figsize: float = 4.5,
):
    """Plot images side by side; returns (fig, axes).

    Accepts RGB (H, W, 3) float [0,1] / uint8 or mono (H, W) arrays.
    """
    imgs = [_np(im) for im in imgs]
    n = len(imgs)
    if isinstance(cmaps, str):
        cmaps = [cmaps] * n
    ratios = ([im.shape[1] / im.shape[0] for im in imgs]
              if adaptive else [4.0 / 3.0] * n)
    fig, axes = plt.subplots(
        1, n, figsize=(sum(ratios) * figsize, figsize), dpi=dpi,
        gridspec_kw={"width_ratios": ratios}, squeeze=False,
    )
    axes = axes[0]
    for ax, im, cm in zip(axes, imgs, cmaps):
        ax.imshow(im, cmap=plt.get_cmap(cm))
        ax.set_axis_off()
    if titles:
        for ax, t in zip(axes, titles):
            ax.set_title(t)
    fig.tight_layout(pad=pad)
    return fig, list(axes)


def plot_keypoints(
    axes,
    kpts: Sequence[np.ndarray],
    colors: Union[str, Sequence] = "lime",
    ps: float = 4.0,
) -> None:
    """Scatter keypoints (list of (N, 2) x,y arrays) onto existing axes."""
    if isinstance(colors, str):
        colors = [colors] * len(kpts)
    for ax, kp, c in zip(axes, kpts, colors):
        kp = _np(kp)
        if len(kp):
            ax.scatter(kp[:, 0], kp[:, 1], c=c, s=ps, linewidths=0)


def plot_matches(
    fig,
    ax0,
    ax1,
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    color=None,
    lw: float = 1.5,
    ps: float = 4.0,
    alpha: float = 1.0,
) -> None:
    """Draw correspondence lines between two image axes.

    One vectorized LineCollection in figure coordinates (fast for thousands
    of matches). ``color`` may be a single color or an (N, 3) array.
    """
    kpts0 = _np(kpts0, np.float64)
    kpts1 = _np(kpts1, np.float64)
    if kpts0.shape != kpts1.shape:
        raise ValueError(f"keypoint sets of shapes {kpts0.shape} and "
                         f"{kpts1.shape}")
    n = len(kpts0)
    if n == 0:
        return
    if color is None:
        color = np.random.default_rng(0).uniform(0.1, 0.9, (n, 3))
    elif not isinstance(color, str):
        color = _np(color)
    fig.canvas.draw()  # freeze transforms before converting coordinates
    inv = fig.transFigure.inverted()
    p0 = inv.transform(ax0.transData.transform(kpts0))
    p1 = inv.transform(ax1.transData.transform(kpts1))
    segs = np.stack([p0, p1], axis=1)            # (N, 2, 2)
    lc = LineCollection(
        segs, colors=color, linewidths=lw, alpha=alpha,
        transform=fig.transFigure, zorder=1,
    )
    fig.add_artist(lc)
    ax0.autoscale(enable=False)
    ax1.autoscale(enable=False)
    if ps > 0:
        ax0.scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=ps)
        ax1.scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=ps)


def add_text(
    ax,
    text: str,
    pos: Tuple[float, float] = (0.01, 0.99),
    fs: float = 15,
    color: str = "w",
    lcolor: Optional[str] = "k",
    lwidth: float = 2.0,
    ha: str = "left",
    va: str = "top",
) -> None:
    """Overlay outlined text in axes-fraction coordinates."""
    t = ax.text(*pos, text, fontsize=fs, ha=ha, va=va, color=color,
                transform=ax.transAxes)
    if lcolor is not None:
        t.set_path_effects([
            path_effects.Stroke(linewidth=lwidth, foreground=lcolor),
            path_effects.Normal(),
        ])


def save_plot(fig, path, **kw) -> None:
    """Save a figure without white margins and release it."""
    fig.savefig(path, bbox_inches="tight", pad_inches=0, **kw)
    plt.close(fig)


# ------------------------------------------------------------- SfM overlays
def visualize_sfm_2d(
    model: Tuple[Dict, Dict, Dict],
    image_of: Dict[str, np.ndarray],
    color_by: str = "visibility",
    selected: Sequence[str] = (),
    n: int = 1,
    seed: int = 0,
    dpi: int = 75,
) -> List:
    """Keypoint overlays for registered model images (one figure each).

    ``model`` is the (cameras, images, points3d) triple of
    ``data.colmap.read_colmap_model``; ``image_of`` maps image name -> pixel
    array. ``color_by``: 'visibility' (blue = has a 3D point, red = not),
    'track_length' (jet of log track length), 'depth' (jet of view-space z
    of visible points). Returns the created figures.
    """
    _, images, points3d = model
    by_name = {im.name: im for im in images.values()}
    names = [s for s in selected if s in by_name] or list(
        np.random.default_rng(seed).permutation(sorted(by_name)))[:n]
    figs = []
    for name in names:
        im = by_name[name]
        kp = np.asarray(im.xys, np.float64)
        p3ids = np.asarray(im.point3d_ids)
        visible = p3ids >= 0
        if color_by == "visibility":
            color = np.where(visible[:, None],
                             np.array([[0.0, 0.0, 1.0]]),
                             np.array([[1.0, 0.0, 0.0]]))
            text = f"visible: {int(visible.sum())}/{len(visible)}"
        elif color_by == "track_length":
            tl = np.array([
                len(points3d[int(j)].image_ids) if v else 1
                for j, v in zip(p3ids, visible)
            ], np.float64)
            text = (f"max/median track length: {int(tl.max())}/"
                    f"{np.median(tl[tl > 1]) if (tl > 1).any() else 0}")
            ltl = np.log(np.maximum(tl, 1.0))
            color = plt.get_cmap("jet")(ltl / max(ltl.max(), 1e-9))[:, :3]
        elif color_by == "depth":
            R, t = im.rotmat(), im.tvec
            z = np.array([
                (R @ points3d[int(j)].xyz + t)[2] for j in p3ids[visible]
            ])
            z = z - z.min() if len(z) else z
            denom = np.percentile(z, 99.9) if len(z) else 1.0
            color = plt.get_cmap("jet")(z / max(denom, 1e-9))[:, :3]
            text = f"visible: {int(visible.sum())}/{len(visible)}"
            kp = kp[visible]
        else:
            raise ValueError(f"unknown color_by '{color_by}'")
        fig, axes = plot_images([image_of[name]], dpi=dpi)
        plot_keypoints(axes, [kp], colors=[color], ps=4)
        add_text(axes[0], text)
        add_text(axes[0], name, pos=(0.01, 0.01), fs=5, lcolor=None,
                 va="bottom")
        figs.append(fig)
    return figs


def visualize_loc(
    query_image: np.ndarray,
    db_image: np.ndarray,
    kp_query: np.ndarray,
    kp_db: np.ndarray,
    inliers: Optional[np.ndarray] = None,
    query_name: str = "query",
    db_name: str = "db",
    dpi: int = 75,
):
    """Query <-> retrieved-image match overlay, inliers green / outliers red
    (reference visualize_loc_from_log, visualization.py:99-163). Returns the
    figure."""
    kp_query = _np(kp_query)
    kp_db = _np(kp_db)
    inliers = (np.ones(len(kp_query), bool) if inliers is None
               else _np(inliers))
    color = error_colormap(inliers.astype(np.float32))
    fig, axes = plot_images([query_image, db_image], dpi=dpi)
    plot_matches(fig, axes[0], axes[1], kp_query, kp_db, color=color,
                 alpha=0.3)
    add_text(axes[0], f"inliers: {int(np.sum(inliers))}/{len(inliers)}")
    opts = dict(pos=(0.01, 0.01), fs=5, lcolor=None, va="bottom")
    add_text(axes[0], query_name, **opts)
    add_text(axes[1], db_name, **opts)
    return fig


# ------------------------------------------------------------------- 3D ----
def init_figure_3d(height: float = 8.0):
    """(fig, ax3d) with equal-data aspect and no chrome."""
    fig = plt.figure(figsize=(height, height))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_axis_off()
    ax.set_box_aspect((1, 1, 1))
    return fig, ax


def plot_points3d(ax, pts: np.ndarray, color="r", ps: float = 2.0,
                  name: Optional[str] = None) -> None:
    pts = _np(pts)
    if not isinstance(color, str):
        color = _np(color)
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=color, s=ps,
                   linewidths=0, label=name)


def frustum_corners(R: np.ndarray, t: np.ndarray, K: np.ndarray,
                    size: float = 1.0) -> np.ndarray:
    """Camera-frustum corner points in world coordinates.

    ``R, t`` are world-from-camera (c2w); returns (5, 3): apex then the four
    image-plane corners, scaled like the reference (viz_3d.py:89-99).
    """
    K = _np(K, np.float64)
    R, t = _np(R, np.float64), _np(t, np.float64)
    W, H = K[0, 2] * 2.0, K[1, 2] * 2.0
    corners_px = np.array(
        [[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], np.float64)
    image_extent = max(size * W / 1024.0, size * H / 1024.0)
    world_extent = max(W, H) / (K[0, 0] + K[1, 1]) / 0.5
    scale = 0.5 * image_extent / max(world_extent, 1e-12)
    rays = corners_px @ np.linalg.inv(K).T            # (4, 3) at z=1
    cam_pts = rays / 2.0 * scale
    world = cam_pts @ R.T + t
    return np.concatenate([t[None], world], axis=0)


def plot_camera_frustum(ax, R: np.ndarray, t: np.ndarray, K: np.ndarray,
                        color="b", size: float = 1.0,
                        lw: float = 1.0) -> None:
    """Wireframe frustum from a world-from-camera pose + intrinsics."""
    v = frustum_corners(R, t, K, size=size)
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for i, j in edges:
        ax.plot([v[i, 0], v[j, 0]], [v[i, 1], v[j, 1]], [v[i, 2], v[j, 2]],
                c=color, lw=lw)


def plot_reconstruction_3d(
    ax,
    model: Tuple[Dict, Dict, Dict],
    max_reproj_error: float = 6.0,
    min_track_length: int = 2,
    color: str = "b",
    points: bool = True,
    cameras: bool = True,
    points_rgb: bool = True,
    camera_size: float = 1.0,
) -> None:
    """COLMAP model triple -> 3D scatter + camera frustums.

    Filters points like the reference (viz_3d.py:170-203): inside the
    0.1%..99.9% bounding box, reprojection error and track length gates.
    """
    cams, images, points3d = model
    if points and points3d:
        xyz = np.array([p.xyz for p in points3d.values()])
        err = np.array([p.error for p in points3d.values()])
        tlen = np.array([len(p.image_ids) for p in points3d.values()])
        rgb = np.array([p.rgb for p in points3d.values()], np.float64) / 255.0
        lo = np.percentile(xyz, 0.1, axis=0)
        hi = np.percentile(xyz, 99.9, axis=0)
        keep = ((xyz >= lo).all(1) & (xyz <= hi).all(1)
                & (err <= max_reproj_error) & (tlen >= min_track_length))
        plot_points3d(ax, xyz[keep],
                      color=rgb[keep] if points_rgb else color, ps=1.0)
    if cameras:
        for im in images.values():
            R_w2c, t_w2c = im.rotmat(), im.tvec
            R_c2w = R_w2c.T
            t_c2w = -R_w2c.T @ t_w2c
            cam = cams[im.camera_id]
            K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                          [0, 0, 1]])
            plot_camera_frustum(ax, R_c2w, t_c2w, K, color=color,
                                size=camera_size)


def plot_gaussian_map_3d(ax, gaussians, max_points: int = 20000,
                         ps: float = 1.5, seed: int = 0) -> None:
    """Scatter a trained Gaussian map's live means coloured by their DC
    colour (SH DC -> RGB through ``core.sh.SH_C0``), at most
    ``max_points`` of them drawn from ``seed``: a 3D check of a map
    without a viewer."""
    from ..core.sh import SH_C0

    xyz = _np(gaussians.xyz)
    dc = _np(gaussians.features_dc)[:, 0, :]
    live = _np(getattr(gaussians, "live", np.ones(len(xyz), bool)))
    idx = np.nonzero(live)[0]
    if len(idx) > max_points:
        idx = np.random.default_rng(seed).choice(idx, max_points,
                                                 replace=False)
    rgb = np.clip(dc[idx] * SH_C0 + 0.5, 0.0, 1.0)
    plot_points3d(ax, xyz[idx], color=rgb, ps=ps)
