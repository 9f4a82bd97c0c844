"""Plain 3D Gaussian splatting: projection, tile binning, front-to-back
blending, in any floating dtype.

The benchmark's own statement of what the program computes, written from
the published method (Kerbl et al. 2023, "3D Gaussian Splatting for
Real-Time Radiance Field Rendering": EWA projection with the Jacobian clamp
at 1.3 tan(fov) and the +0.3 low-pass, 16x16 tiles, depth-ordered
compositing with alpha = min(0.99, opacity * G), pairs below 1/255 skipped,
a pixel stopped once its transmittance would fall below 1e-4) and the
binning conventions the program promises (tile rects from the smaller of
the 3-sigma and the opacity radius; a (Gaussian, tile) pair kept only where
its alpha can reach 1/255 somewhere in the tile's pixel-centre box).

Nothing here imports the program. Every tensor is computed in ``dtype``;
the tile lists are built once per pose and can be held fixed while the pose
moves (the program's pose mode), with colours frozen at the binning view.
Blending runs over blocks of whole tiles, padded to the longest list of the
block, so that a block's tensors stay within a fixed element budget.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

TILE = 16
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_EPS = math.log(1e-4)
NEAR = 0.2
BLOCK_ELEMS = 1 << 24          # (tiles, lanes, pixels) elements per block

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# columns of the per-Gaussian screen-space table
PX, PY, CA, CB, CC, OPA, VALID, R, G, B, Z = range(11)


@dataclasses.dataclass(frozen=True)
class Cam:
    """Pinhole camera: world-to-camera 4x4 and intrinsics (pixel centres at
    integer coordinates, principal point at (cx - 0.5, cy - 0.5))."""

    w2c: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def at(self, w2c: torch.Tensor) -> "Cam":
        return dataclasses.replace(self, w2c=w2c)

    @property
    def grid(self):
        return -(-self.width // TILE), -(-self.height // TILE)


class Map(NamedTuple):
    """Gaussian parameters as trained: log scales, unnormalised wxyz
    quaternions, logit opacities, SH coefficients (N, K, 3)."""

    xyz: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    opacity_logit: torch.Tensor    # (N,)
    sh: torch.Tensor
    sh_degree: int

    def to(self, dtype) -> "Map":
        return Map(*(t.to(dtype) for t in self[:5]), self.sh_degree)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """Twist [rho, theta] -> 4x4 transform (Rodrigues; series below 1e-5
    rad, so that the derivative at 0 is exact)."""
    rho, theta = tau[:3], tau[3:]
    W = skew(theta)
    W2 = W @ W
    sq = torch.sum(theta * theta)
    small = sq < 1e-10
    a = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    s1 = torch.where(small, torch.ones_like(a), torch.sin(a) / a)
    c1 = torch.where(small, torch.full_like(a, 0.5), (1 - torch.cos(a)) / a**2)
    c2 = torch.where(small, torch.full_like(a, 1 / 6),
                     (a - torch.sin(a)) / a**3)
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device)
    rot = eye + s1 * W + c1 * W2
    t = (eye + c1 * W + c2 * W2) @ rho
    top = torch.cat([rot, t[:, None]], 1)
    bottom = torch.tensor([[0, 0, 0, 1]], dtype=tau.dtype, device=tau.device)
    return torch.cat([top, bottom], 0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.sqrt(torch.clamp_min(torch.sum(q * q, -1, keepdim=True),
                                       1e-20))
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def sh_rgb(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH of degree <= 3 along unit dirs, + 0.5, clamped at 0."""
    out = SH_C0 * sh[:, 0]
    if degree > 0:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
        if degree > 1:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
                   + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
                   + SH_C2[3] * xz * sh[:, 7]
                   + SH_C2[4] * (xx - yy) * sh[:, 8])
            if degree > 2:
                out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
                       + SH_C3[1] * xy * z * sh[:, 10]
                       + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
                       + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
                       + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
                       + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                       + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(out + 0.5, 0.0)


class Screen(NamedTuple):
    """Per-Gaussian screen quantities: the (N, 11) table the blend reads,
    and the tile rect and culling values the binning reads."""

    table: torch.Tensor     # columns PX .. Z
    rect: torch.Tensor      # (N, 4) int64 x0, y0, x1, y1 (exclusive)
    qmax: torch.Tensor      # (N,) largest conic quadratic still >= 1/255


def project(m: Map, cam: Cam, rgb: Optional[torch.Tensor] = None,
            means2d_offset: Optional[torch.Tensor] = None,
            valid_fixed: Optional[torch.Tensor] = None) -> Screen:
    """EWA projection of every Gaussian (differentiable in the map and in
    ``cam.w2c``). Pose mode passes the binning view's colours (``rgb``) and
    validity (``valid_fixed``), which then only drops Gaussians that came
    nearer than the near plane or degenerated."""
    w2c = cam.w2c
    rot, t = w2c[:3, :3], w2c[:3, 3]
    v = m.xyz @ rot.T + t
    x, y, z = v.unbind(-1)
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    px = cam.fx * x / zs + cam.cx - 0.5
    py = cam.fy * y / zs + cam.cy - 0.5
    if means2d_offset is not None:
        px = px + means2d_offset[:, 0]
        py = py + means2d_offset[:, 1]

    mscale = quat_to_rot(m.quat) * torch.exp(m.log_scale)[:, None, :]
    cov = mscale @ mscale.transpose(1, 2)
    vc = rot @ cov @ rot.T
    limx = 1.3 * cam.width / (2 * cam.fx)
    limy = 1.3 * cam.height / (2 * cam.fy)
    tx = torch.clamp(x / zs, -limx, limx) * zs
    ty = torch.clamp(y / zs, -limy, limy) * zs
    j00, j11 = cam.fx / zs, cam.fy / zs
    j02, j12 = -cam.fx * tx / zs**2, -cam.fy * ty / zs**2
    a = j00 * j00 * vc[:, 0, 0] + 2 * j00 * j02 * vc[:, 0, 2] \
        + j02 * j02 * vc[:, 2, 2] + 0.3
    b = j00 * j11 * vc[:, 0, 1] + j00 * j12 * vc[:, 0, 2] \
        + j02 * j11 * vc[:, 1, 2] + j02 * j12 * vc[:, 2, 2]
    c = j11 * j11 * vc[:, 1, 1] + 2 * j11 * j12 * vc[:, 1, 2] \
        + j12 * j12 * vc[:, 2, 2] + 0.3
    det = a * c - b * b
    det_s = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    opa = torch.sigmoid(m.opacity_logit)
    if rgb is None:
        campos = -rot.T @ t
        d = m.xyz - campos
        d = d / torch.sqrt(torch.clamp_min(torch.sum(d * d, -1, keepdim=True),
                                           1e-20))
        rgb = sh_rgb(m.sh, d, m.sh_degree)

    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        r3 = torch.ceil(3 * torch.sqrt(torch.clamp_min(lam, 0)))
        lg = 2 * torch.log(torch.clamp_min(opa, 1e-30) * 255)
        r_op = torch.sqrt(torch.clamp_min(lg, 0) * torch.clamp_min(lam, 0))
        rad = torch.minimum(r3, torch.ceil(r_op))
        gx, gy = cam.grid
        finite = (torch.isfinite(px) & torch.isfinite(py)
                  & torch.isfinite(r3) & torch.isfinite(r_op))

        def edge(val, hi):
            return torch.where(finite, torch.clamp(torch.floor(val / TILE),
                                                   0, hi),
                               torch.zeros_like(val)).to(torch.int64)

        rect = torch.stack([edge(px - rad, gx), edge(py - rad, gy),
                            edge(px + rad + TILE - 1, gx),
                            edge(py + rad + TILE - 1, gy)], -1)
        area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        valid = (finite & (z > NEAR) & (torch.abs(det) > 1e-12)
                 & (area > 0) & (r_op > 0))
        if valid_fixed is not None:
            valid = valid_fixed & (z > NEAR) & (torch.abs(det) > 1e-12)
        qmax = torch.where(opa > ALPHA_MIN, lg, torch.full_like(opa, -1.0))
    table = torch.stack([px, py, c / det_s, -b / det_s, a / det_s, opa,
                         valid.to(px.dtype), rgb[:, 0], rgb[:, 1], rgb[:, 2],
                         z], -1)
    return Screen(table, rect, qmax)


def _qmin(mx, my, ca, cb, cc, tx, ty):
    """Least value of ca dx^2 + 2 cb dx dy + cc dy^2 over a tile's
    pixel-centre box (0 where the mean lies inside it)."""
    xlo = tx * TILE - mx
    xhi = xlo + (TILE - 1)
    ylo = ty * TILE - my
    yhi = ylo + (TILE - 1)
    inside = (xlo <= 0) & (xhi >= 0) & (ylo <= 0) & (yhi >= 0)
    ca_s, cc_s = torch.clamp_min(ca, 1e-12), torch.clamp_min(cc, 1e-12)

    def along_x(ex):                 # x fixed at an edge, best y on the edge
        ys = torch.minimum(torch.maximum(-cb * ex / cc_s, ylo), yhi)
        return ca * ex * ex + 2 * cb * ex * ys + cc * ys * ys

    def along_y(ey):
        xs = torch.minimum(torch.maximum(-cb * ey / ca_s, xlo), xhi)
        return ca * xs * xs + 2 * cb * xs * ey + cc * ey * ey

    q = torch.minimum(torch.minimum(along_x(xlo), along_x(xhi)),
                      torch.minimum(along_y(ylo), along_y(yhi)))
    return torch.where(inside, torch.zeros_like(q), q)


class Tiles(NamedTuple):
    """(Gaussian, tile) pairs grouped by tile, each tile's list in depth
    order."""

    gauss: torch.Tensor      # (pairs,) int64
    start: torch.Tensor      # (tiles + 1,) int64 offsets into ``gauss``
    num_tiles: int


def bin_tiles(scr: Screen, cam: Cam) -> Tiles:
    """Tile lists at the pose the screen table was projected at."""
    with torch.no_grad():
        tab = scr.table
        gx, gy = cam.grid
        dev = tab.device
        valid = tab[:, VALID] > 0.5
        ids = torch.nonzero(valid, as_tuple=True)[0]
        rect = scr.rect[ids]
        w = rect[:, 2] - rect[:, 0]
        h = rect[:, 3] - rect[:, 1]
        n = w * h
        g = torch.repeat_interleave(ids, n)
        first = torch.cumsum(n, 0) - n
        k = torch.arange(int(n.sum()), device=dev) - torch.repeat_interleave(
            first, n)
        wr = torch.repeat_interleave(w, n)
        tx = torch.repeat_interleave(rect[:, 0], n) + k % wr
        ty = torch.repeat_interleave(rect[:, 1], n) + k // wr
        row = tab[g]
        q = _qmin(row[:, PX], row[:, PY], row[:, CA], row[:, CB], row[:, CC],
                  tx.to(tab.dtype), ty.to(tab.dtype))
        keep = q <= scr.qmax[g]
        g, tile = g[keep], (ty * gx + tx)[keep]
        rank = torch.empty_like(ids)
        rank[torch.argsort(tab[ids, Z], stable=True)] = torch.arange(
            ids.numel(), device=dev)
        rank_of = torch.zeros(tab.shape[0], dtype=torch.int64, device=dev)
        rank_of[ids] = rank
        order = torch.argsort(tile * (tab.shape[0] + 1) + rank_of[g])
        g, tile = g[order], tile[order]
        counts = torch.bincount(tile, minlength=gx * gy)
        start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(counts, 0)])
        return Tiles(g, start, gx * gy)


class Blend(NamedTuple):
    color: torch.Tensor      # (H, W, 3)
    depth: torch.Tensor      # (H, W)  sum of weights * view depth
    alpha: torch.Tensor      # (H, W)  1 - final transmittance
    evaluated: int           # (pixel, pair) pairs reached before saturation
    applied: int             # of them, composited


def _blocks(tiles: Tiles):
    """Blocks of whole tiles, longest lists first, each padded to its
    longest list and kept within BLOCK_ELEMS."""
    counts = tiles.start[1:] - tiles.start[:-1]
    order = torch.argsort(counts, descending=True, stable=True)
    cnt = counts[order].tolist()
    out, lo = [], 0
    while lo < len(cnt) and cnt[lo] > 0:
        lanes = cnt[lo]
        per = max(1, BLOCK_ELEMS // (lanes * TILE * TILE))
        hi = lo
        while hi < len(cnt) and hi - lo < per and cnt[hi] > 0:
            hi += 1
        out.append((order[lo:hi], lanes))
        lo = hi
    return out


def _blend_block(table, tiles: Tiles, sel, lanes: int, gx: int):
    """Blend one block: per tile of ``sel`` its (256,) colour, depth and
    log transmittance, and the evaluated / applied counts."""
    dev, dt = table.device, table.dtype
    lane = torch.arange(lanes, device=dev)
    cnt = tiles.start[sel + 1] - tiles.start[sel]
    live = lane[None, :] < cnt[:, None]
    idx = torch.clamp(tiles.start[sel][:, None] + lane[None, :], 0,
                      max(tiles.gauss.numel() - 1, 0))
    f = table[tiles.gauss[idx]]                       # (T, L, 11)
    pix = torch.arange(TILE * TILE, device=dev)
    x = ((sel % gx) * TILE)[:, None] + (pix % TILE)[None, :]
    y = ((sel // gx) * TILE)[:, None] + (pix // TILE)[None, :]
    dx = f[:, :, PX, None] - x[:, None, :].to(dt)
    dy = f[:, :, PY, None] - y[:, None, :].to(dt)
    power = (-0.5 * (f[:, :, CA, None] * dx * dx + f[:, :, CC, None] * dy * dy)
             - f[:, :, CB, None] * dx * dy)
    alpha = torch.clamp_max(f[:, :, OPA, None] * torch.exp(
        torch.clamp_max(power, 0.0)), ALPHA_MAX)
    on = ((power <= 0) & (alpha >= ALPHA_MIN)
          & (f[:, :, VALID, None] > 0.5) & live[:, :, None])
    alpha = torch.where(on, alpha, torch.zeros_like(alpha))
    la = torch.log1p(-alpha)
    clog = torch.cumsum(la, 1)
    with torch.no_grad():
        applied = on & (clog >= LOG_T_EPS)
        evaluated = live[:, :, None] & (clog - la >= LOG_T_EPS)
    w = torch.where(applied, alpha * torch.exp(clog - la),
                    torch.zeros_like(alpha))
    color = torch.einsum("tlp,tlc->tpc", w, f[:, :, R:B + 1])
    depth = torch.einsum("tlp,tl->tp", w, f[:, :, Z])
    logt = torch.sum(torch.where(applied, la, torch.zeros_like(la)), 1)
    return color, depth, logt, int(evaluated.sum()), int(applied.sum())


def _to_image(tiles_val, gx, gy, width, height):
    chan = tuple(tiles_val.shape[2:])
    img = tiles_val.reshape((gy, gx, TILE, TILE) + chan)
    img = torch.movedim(img, 2, 1).reshape((gy * TILE, gx * TILE) + chan)
    return img[:height, :width]


def blend(table: torch.Tensor, tiles: Tiles, cam: Cam) -> Blend:
    """Forward blend of every tile (no autograd graph)."""
    gx, gy = cam.grid
    nt = tiles.num_tiles
    dev, dt = table.device, table.dtype
    color = torch.zeros((nt, TILE * TILE, 3), dtype=dt, device=dev)
    depth = torch.zeros((nt, TILE * TILE), dtype=dt, device=dev)
    logt = torch.zeros((nt, TILE * TILE), dtype=dt, device=dev)
    n_eval = n_app = 0
    with torch.no_grad():
        for sel, lanes in _blocks(tiles):
            c, d, lt, e, a = _blend_block(table, tiles, sel, lanes, gx)
            color[sel], depth[sel], logt[sel] = c, d, lt
            n_eval += e
            n_app += a
    return Blend(_to_image(color, gx, gy, cam.width, cam.height),
                 _to_image(depth, gx, gy, cam.width, cam.height),
                 _to_image(1 - torch.exp(logt), gx, gy, cam.width, cam.height),
                 n_eval, n_app)


def blend_vjp(table: torch.Tensor, tiles: Tiles, cam: Cam, g_color,
              g_depth, g_alpha) -> torch.Tensor:
    """The gradient of <g, blend(table)> with respect to ``table``, block
    by block (each block's graph is freed before the next)."""
    gx, gy = cam.grid
    leaf = table.detach().requires_grad_()
    pad_h, pad_w = gy * TILE - cam.height, gx * TILE - cam.width

    def tiled(img):
        img = torch.nn.functional.pad(
            img.movedim(-1, 0) if img.dim() == 3 else img[None],
            (0, pad_w, 0, pad_h))
        img = img.reshape(-1, gy, TILE, gx, TILE).permute(1, 3, 2, 4, 0)
        return img.reshape(gy * gx, TILE * TILE, -1)

    gc, gd, ga = tiled(g_color), tiled(g_depth)[..., 0], tiled(g_alpha)[..., 0]
    grad = torch.zeros_like(table)
    for sel, lanes in _blocks(tiles):
        with torch.enable_grad():
            c, d, lt, _, _ = _blend_block(leaf, tiles, sel, lanes, gx)
            s = (torch.sum(c * gc[sel]) + torch.sum(d * gd[sel])
                 - torch.sum(torch.exp(lt) * ga[sel]))
            (gb,) = torch.autograd.grad(s, leaf)
        grad += gb
    return grad


def render_with_grad(table: torch.Tensor, tiles: Tiles, cam: Cam, loss_fn):
    """loss_fn(color, depth, alpha) -> scalar. Returns (loss, rendered
    Blend) after backpropagating the loss through ``table``'s graph and
    into any other leaf the loss reads."""
    out = blend(table.detach(), tiles, cam)
    imgs = [t.detach().requires_grad_() for t in out[:3]]
    with torch.enable_grad():
        loss = loss_fn(*imgs)
        loss.backward()      # into the images and the loss's own leaves
    gimg = [torch.zeros_like(i) if i.grad is None else i.grad for i in imgs]
    gtab = blend_vjp(table, tiles, cam, *gimg)
    if table.requires_grad:
        table.backward(gtab)
    return loss.detach(), out
