"""The work one DPT_Hybrid forward needs, counted from its layer shapes.

The yardstick under ``prior_roofline.fewshot`` and the prior's part of
``mfu.fewshot``, frozen beside ``workcount.py``: it counts what the
network's layers need at an input size (``reference/dpt.py``'s network),
not what the program issues.

Operations (a multiply-add counts 2):

- every convolution 2 k^2 C_in C_out per output value, every linear layer
  2 C_in C_out per token, attention's two products 2 N^2 C each;
- weight standardisation 5 per kernel weight (mean, variance, scale),
  GroupNorm and LayerNorm 8 per value and ReLU 1, GELU 8, softmax 5, a
  2x bilinear upsampling 8 per output value, each residual or skip sum 1,
  the input's normalisation 2 per value.

Bytes: every weight read once, the input image read and the inverse depth
written once (float32), intermediate maps not counted.
"""

from __future__ import annotations

from typing import NamedTuple

EMBED, HEADS, MLP, FEAT = 768, 12, 3072, 256
STAGES = ((3, 256), (4, 512), (9, 1024))
DEPTH = 12
POS_GRID = 24            # the checkpoint's position embeddings: 24 x 24
NET_SIZE = (384, 512)


class Work(NamedTuple):
    flops: float
    nbytes: float
    params: int


class _Count:
    def __init__(self):
        self.flops = 0.0
        self.params = 0

    def conv(self, cin, cout, k, ho, wo, bias=True, std=False, norm=None):
        self.flops += 2.0 * k * k * cin * cout * ho * wo
        w = k * k * cin * cout
        self.params += w + (cout if bias else 0)
        if std:
            self.flops += 5.0 * w
        if norm is not None:                 # GroupNorm, then ReLU or not
            self.params += 2 * cout
            self.flops += (8.0 + (1.0 if norm else 0.0)) * cout * ho * wo

    def linear(self, cin, cout, tokens):
        self.flops += 2.0 * cin * cout * tokens
        self.params += cin * cout + cout

    def elementwise(self, per, values):
        self.flops += float(per) * values


def _out(n, s):
    return -(-n // s)


def count(h: int = NET_SIZE[0], w: int = NET_SIZE[1]) -> Work:
    """DPT_Hybrid at an ``h`` x ``w`` input (multiples of 32)."""
    c = _Count()
    c.elementwise(2, 3 * h * w)
    # stem: 7x7 stride 2, GN + ReLU, 3x3 stride-2 max pool
    hh, ww = _out(h, 2), _out(w, 2)
    c.conv(3, 64, 7, hh, ww, bias=False, std=True, norm=True)
    hh, ww = _out(hh, 2), _out(ww, 2)
    c.elementwise(9, 64 * hh * ww)
    cin = 64
    taps = []
    for s, (blocks, cout) in enumerate(STAGES):
        mid = cout // 4
        for i in range(blocks):
            stride = 2 if (s > 0 and i == 0) else 1
            ho, wo = _out(hh, stride), _out(ww, stride)
            if i == 0:
                c.conv(cin, cout, 1, ho, wo, bias=False, std=True,
                       norm=False)
            c.conv(cin if i == 0 else cout, mid, 1, hh, ww, bias=False,
                   std=True, norm=True)
            c.conv(mid, mid, 3, ho, wo, bias=False, std=True, norm=True)
            c.conv(mid, cout, 1, ho, wo, bias=False, std=True, norm=False)
            c.elementwise(2, cout * ho * wo)        # residual sum, ReLU
            hh, ww = ho, wo
        taps.append((cout, hh, ww))
        cin = cout
    gh, gw = hh, ww
    n = gh * gw + 1
    c.conv(1024, EMBED, 1, gh, gw)                   # patch embedding
    c.params += EMBED + (1 + POS_GRID * POS_GRID) * EMBED
    c.elementwise(8 + 1, gh * gw * EMBED)            # pos resize, add
    for _ in range(DEPTH):
        c.params += 4 * EMBED                        # the two LayerNorms
        c.elementwise(8, 2 * n * EMBED)
        c.linear(EMBED, 3 * EMBED, n)
        c.elementwise(2 * 2 * (EMBED // HEADS), HEADS * n * n)  # QK^T, AV
        c.elementwise(5, HEADS * n * n)              # softmax
        c.linear(EMBED, EMBED, n)
        c.linear(EMBED, MLP, n)
        c.elementwise(8, n * MLP)                    # GELU
        c.linear(MLP, EMBED, n)
        c.elementwise(2, n * EMBED)                  # the residual sums
    for _ in (3, 4):                                 # project readouts
        c.linear(2 * EMBED, EMBED, gh * gw)
        c.elementwise(8, gh * gw * EMBED)
    c.conv(EMBED, EMBED, 1, gh, gw)                  # tap 3
    c.conv(EMBED, EMBED, 1, gh, gw)                  # tap 4
    c.conv(EMBED, EMBED, 3, _out(gh, 2), _out(gw, 2))
    maps = [taps[0], taps[1], (EMBED, gh, gw), (EMBED, _out(gh, 2),
                                               _out(gw, 2))]
    for cin_, ho, wo in maps:                        # layer*_rn, no bias
        c.conv(cin_, FEAT, 3, ho, wo, bias=False)
    for k in (4, 3, 2, 1):                           # refinenet4 .. 1
        _, ho, wo = maps[k - 1]
        units = 1 if k == 4 else 2
        for _ in range(units):
            c.conv(FEAT, FEAT, 3, ho, wo)
            c.conv(FEAT, FEAT, 3, ho, wo)
            c.elementwise(3, FEAT * ho * wo)         # two ReLUs, the skip
        if k != 4:
            c.elementwise(1, FEAT * ho * wo)         # the fusion's sum
        c.elementwise(8, FEAT * 4 * ho * wo)         # 2x up
        c.conv(FEAT, FEAT, 1, 2 * ho, 2 * wo)
    hh, ww = 2 * maps[0][1], 2 * maps[0][2]          # h / 2, w / 2
    c.conv(FEAT, FEAT // 2, 3, hh, ww)
    c.elementwise(8, (FEAT // 2) * 4 * hh * ww)
    c.conv(FEAT // 2, 32, 3, 2 * hh, 2 * ww)
    c.elementwise(1, 32 * 4 * hh * ww)
    c.conv(32, 1, 1, 2 * hh, 2 * ww)
    c.elementwise(1, 4 * hh * ww)
    nbytes = 4.0 * (c.params + 3 * h * w + h * w)
    return Work(c.flops, nbytes, c.params)
