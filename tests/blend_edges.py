"""Seeded blend windows at the edges of the kernels' piece walks, in numpy,
for the pregathered layout and laid into a pair stream. Imports no JAX, so
that the card tests that use it also run on a machine that has none."""

import numpy as np

EDGE_GRID = (4, 3)


def edge_windows(chunk: int, seed: int = 0):
    """Seeded pregathered windows (numpy) of EDGE_GRID tiles at cap = 8
    chunks, whose counts sit at the kernels' edges, in shuffled order: 0;
    1, 63, 65 and 255 (ending inside a 64-lane piece); 64 and 128 (on a
    piece's end); the cap; 7 chunks and 8 lanes; and a tile of opaque
    splats that saturates in its first chunk (k_stop 1, later chunks
    unvisited). Deep tiles hold faint splats and walk every chunk."""
    rng = np.random.default_rng(seed)
    gx, gy = EDGE_GRID
    cap = 8 * chunk
    counts = np.array([65, 0, cap, 1, 255, 63, 7 * chunk + 8, cap, 300, 64,
                       128, 4 * chunk + 5], np.int32)
    t = np.arange(gx * gy)
    ox = ((t % gx) * 16 + 7.5)[:, None]
    oy = ((t // gx) * 16 + 7.5)[:, None]
    shape = (len(t), cap)
    x = ox + rng.uniform(-14, 14, shape)
    y = oy + rng.uniform(-14, 14, shape)
    sa = rng.uniform(0.02, 0.4, shape)
    sc = rng.uniform(0.02, 0.4, shape)
    b = rng.uniform(-0.5, 0.5, shape) * np.sqrt(sa * sc)
    opa = rng.uniform(0.05, 0.6, shape)
    deep = counts > 2 * chunk
    opa[deep] = rng.uniform(0.004, 0.03, (int(deep.sum()), cap))
    x[7], y[7] = ox[7] + rng.uniform(-2, 2, cap), oy[7] + rng.uniform(-2, 2, cap)
    sa[7], sc[7], b[7], opa[7] = 0.005, 0.005, 0.0, 0.95
    valid = (rng.uniform(size=shape) > 0.1).astype(np.float64)
    geom = np.stack([x, y, sa, b, sc, opa, valid, np.zeros(shape)], 1)
    rgbd = np.concatenate([rng.uniform(0, 1, (len(t), 3, cap)),
                           rng.uniform(1, 5, (len(t), 1, cap))], 1)
    return counts, geom.astype(np.float32), rgbd.astype(np.float32)


def edge_stream(counts, geom, rgbd, chunk: int):
    """The same windows as one transposed pair stream (16, T*cap + chunk):
    tile t's window at tstart = t*cap with walk_count = its count, rows 0-11
    from geom and rgbd, rows 12-15 zero, one chunk of zero padding at the
    end. Returns (stream, tstart, walk_counts) as numpy."""
    num_tiles, _, cap = geom.shape
    stream = np.zeros((16, num_tiles * cap + chunk), np.float32)
    rows = np.concatenate([geom, rgbd], 1)                 # (T, 12, cap)
    stream[:12, :num_tiles * cap] = rows.transpose(1, 0, 2).reshape(12, -1)
    tstart = (np.arange(num_tiles) * cap).astype(np.int32)
    return stream, tstart, np.asarray(counts, np.int32)


def drift_window(chunk: int = 256, n_chunks: int = 16, seed: int = 0):
    """One seeded pregathered tile (grid 1 x 1, count = cap = n_chunks
    chunks) whose first pixel row walks thousands of pairs past saturation.

    Each of the 16 pixels of row 0 first gets four pairs of its own,
    centred on it and too narrow to reach a neighbour: alpha 0.97 twice,
    then an alpha that brings log T to log(1e-4) + m with m in [1e-5,
    1e-4] (the last pair the blend applies), then alpha 1/250 (not
    applied); every alpha stays below the 0.99 clamp, whose tie the
    kernels and autograd differentiate differently. Then
    every later lane is a splat centred on row 0, wide along it, of alpha
    0.99 there: row 0 sums log T over all of them to about -4.6 per lane,
    while rows 15 see no splat and keep the tile walking every chunk.
    Rebuilding log T by subtraction from that sum back down through the
    walked pairs drifts by up to the float32 spacing there (~1e-3 at 16
    chunks of 256), of either sign: where it exceeds -m, a backward that
    tells the applied pairs by the rebuilt value misses the last of them.

    Returns (counts, geom, rgbd, planted): ``planted`` is (16, 2) int,
    each planted pixel's index in the tile and one past the lane of its
    last applied pair."""
    rng = np.random.default_rng(seed)
    cap = n_chunks * chunk
    px = np.arange(16)
    n1 = 4 * len(px)
    m = rng.uniform(1e-5, 1e-4, len(px))
    alpha3 = 1.0 - np.exp(np.log(1e-4) + m - 2 * np.log(0.03))
    x = rng.uniform(0.0, 15.0, cap)
    y = np.zeros(cap)
    sa = np.full(cap, 1e-5)
    sc = np.full(cap, 0.05)
    opa = rng.uniform(0.9, 0.985, cap)
    x[:n1] = np.repeat(px, 4)
    sa[:n1] = sc[:n1] = 30.0
    opa[:n1] = np.stack([np.full(len(px), 0.97), np.full(len(px), 0.97),
                         alpha3, np.full(len(px), 1 / 250)], 1).ravel()
    geom = np.stack([x, y, sa, np.zeros(cap), sc, opa, np.ones(cap),
                     np.zeros(cap)])[None]
    rgbd = np.concatenate([rng.uniform(0, 1, (3, cap)),
                           rng.uniform(1, 5, (1, cap))])[None]
    planted = np.stack([px, 4 * px + 3], 1)
    return (np.array([cap], np.int32), geom.astype(np.float32),
            rgbd.astype(np.float32), planted)
