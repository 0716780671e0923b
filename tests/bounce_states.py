"""Random states of one bounce of the depth loop, for the tests of K12 and
its plain version (numpy only: the card tests import it without JAX)."""

import numpy as np


def random_bounce(seed: int, n: int = 4096):
    """(acc, thr, color, kr, p, refl_dir, mask) as numpy arrays, made from
    ``seed``: dead lanes (mask false), kr exactly 0 and -0.0 on some lanes
    and channels, negative and NaN kr, NaN colors on masked lanes and inf
    throughputs."""
    rng = np.random.default_rng(seed)
    f = np.float32
    acc = rng.uniform(-1, 4, (n, 3)).astype(f)
    thr = rng.uniform(0, 1, (n, 3)).astype(f)
    color = rng.uniform(0, 2, (n, 3)).astype(f)
    kr = rng.uniform(-0.2, 1, (n, 3)).astype(f)
    pick = rng.integers(0, 6, (n, 3))
    kr[pick == 0] = 0.0
    kr[pick == 1] = -0.0
    kr[(pick == 2) & (rng.uniform(size=(n, 3)) < 0.1)] = np.nan
    p = rng.normal(size=(n, 3)).astype(f)
    refl = rng.normal(size=(n, 3)).astype(f)
    mask = rng.uniform(size=n) < 0.7
    color[~mask & (rng.uniform(size=n) < 0.5)] = np.nan
    thr[rng.uniform(size=n) < 0.05] = np.inf
    return acc, thr, color, kr, p, refl, mask
