"""Blend gate constants shared by the kernels AND the binning cull.

Reference semantics: alpha = min(0.99, opa*exp(power)), skip alpha < 1/255,
stop when T < 1e-4. The binning cull is exact only if its threshold equals
the kernels' gate, so both read it from here. ``csrc/blend_common.cuh``
repeats the same three values.
"""

import math

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_EPS = float(math.log(1e-4))
