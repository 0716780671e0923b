"""Adversarial light-pick tables and ray ids that reach chosen variates,
for the CPU tests of K8's search (``test_torch_light_pick.py``) and the
card tests of K8 and K10 (``test_torch_kernels.py``). numpy only: the card
tests run where JAX is not installed.

* ``PICK_ROWS``: sets of element-weight rows, as ``build_light_sampler``
  would sum them: ties and zero weights, a zero total, NaN and inf
  weights, ``edge`` padding, one element, tiny and huge weights, and rows
  of 2,048 and 2,047 elements;
* ``cdf_rows``: their f32 cumsum rows, padded with the last value;
* ``ids_for_r0``: ray ids whose first light variate is each value asked
  for, through the inverse of the PCG hash (a bijection on u32).
"""

import numpy as np

U = np.float32(1.0 - 2.0 ** -24)   # the largest variate below 1
LIGHT_SEED_XOR = 0x85EBCA6B          # render/lights.py: seed ^ this
M32 = 0xFFFFFFFF

PICK_ROWS = {
    "ties_and_zeros": [[0, 1, 0, 0, 2, 2, 0, 1], [1, 1, 1, 1, 1, 1, 1, 1],
                       [0, 0, 0, 3, 0, 0, 0, 0]],
    "zero_total": [[0, 0, 0], [0, 0, 0, 0, 0]],
    "nan_weight": [[1, np.nan, 2, 3], [np.nan], [2, 1, 1, np.nan]],
    "inf_weight": [[1, np.inf, 2, 3], [np.inf, 1], [1, 2, np.inf]],
    "edge_padding": [[1], [0.5, 0.25], [1, 2, 3], [3, 0, 0, 0, 0, 0, 0, 4, 1]],
    "one_element": [[2.5]],
    "tiny_and_huge": [[1e-30, 1e30, 1e-30, 1], [3e38, 3e38, 1]],
    "grid_2048": [np.full(2048, 0.5 / 2048, np.float32),
                  np.random.default_rng(1).uniform(0, 1, 2047)],
}

# first variates that put x = r0 * total at 0, at the smallest step, on
# every entry of a row of total 8 (ties_and_zeros' second row) and at the
# top
R0_TARGETS = [0.0, 2.0 ** -24, *(k / 8 for k in range(1, 8)), float(U)]


def cdf_rows(weight_rows, extra=0) -> np.ndarray:
    """f32 cumsum rows of the weights, padded with their last value to the
    longest (``build_light_sampler``'s rows), and ``extra`` entries past
    it."""
    with np.errstate(invalid="ignore", over="ignore"):
        rows = [np.cumsum(np.asarray(w, np.float32)).astype(np.float32)
                for w in weight_rows]
    e = max(len(r) for r in rows) + extra
    return np.stack([np.pad(r, (0, e - len(r)), mode="edge") for r in rows])


def pcg_hash(x: int) -> int:
    """``render/camera.py::pcg_hash`` on one u32."""
    x = (x * 747796405 + 2891336453) & M32
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (w >> 22) ^ w


def pcg_unhash(h: int) -> int:
    """The u32 that ``pcg_hash`` maps to ``h``: each of its three steps
    undone (the xor-shift by 22, the odd multiply, the xor-shift by
    4 + the top 4 bits, which it leaves as they are, then the affine
    step)."""
    w = h ^ (h >> 22)
    t = (w * pow(277803737, -1, 1 << 32)) & M32
    s = (t >> 28) + 4
    x, k = t, s
    while k < 32:
        x ^= t >> k
        k += s
    return ((x - 2891336453) * pow(747796405, -1, 1 << 32)) & M32


def ids_for_r0(seed: int, r0s) -> np.ndarray:
    """(len(r0s),) int32 non-negative ray ids whose first light variate,
    column 0 of ``per_ray_uniform(seed ^ 0x85EBCA6B, ids, 3)``, is each of
    ``r0s`` (multiples of 2^-24 in [0, 1)): the top 24 bits of
    ``pcg(id ^ pcg(lseed))`` are r0 * 2^24, and the low 8 bits are chosen
    so that the id is below 2^31."""
    h0 = pcg_hash(((seed & M32) ^ LIGHT_SEED_XOR) & M32)
    out = []
    for r0 in r0s:
        top = int(np.float64(r0) * 2 ** 24)
        if top * 2.0 ** -24 != r0 or not 0 <= top < 1 << 24:
            raise ValueError(f"{r0} is not a variate")
        ids = (pcg_unhash((top << 8) | low) ^ h0 for low in range(256))
        out.append(next(i for i in ids if i < 1 << 31))
    return np.asarray(out, np.int32)
