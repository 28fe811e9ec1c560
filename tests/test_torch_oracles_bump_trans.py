"""Transcritical steady flow over a bump without a shock (SWASHES, q =
1.53 m^2/s; tests/test_bump_steady.py) on rdycore_tpu_torch's interval
advancer on the CPU, in f64, at the JAX test's size and thresholds: the
flow passes critical depth at the crest, where the Roe solver's entropy
fix acts.
"""

import numpy as np

from test_torch_oracles import G, one_torch_thread  # noqa: F401
from test_torch_oracles_bump import _z, bump_run


def test_transcritical_bump_holds_steady():
    """Transcritical flow without shock (q = 1.53 m^2/s): critical depth
    at the crest, where the Roe solver's entropy fix acts."""
    q_in = 1.53
    hc = (q_in**2 / G) ** (1.0 / 3.0)  # critical depth at the crest
    Htot = hc + q_in**2 / (2 * G * hc**2) + 0.2  # energy head

    def h_branch(x):
        z = _z(x)
        # Newton from the branch-appropriate side of critical depth
        h = np.where(x < 10.0, 2.0 * hc, 0.5 * hc)
        for _ in range(80):
            f = q_in**2 / (2 * G * h**2) + h + z - Htot
            df = 1.0 - q_in**2 / (G * h**3)
            df = np.where(np.abs(df) < 1e-6, np.sign(df + 1e-30) * 1e-6, df)
            step = np.clip(f / df, -0.2 * hc, 0.2 * hc)
            h = np.maximum(h - step, 0.05)
        return h

    x, h0, h1, hu1 = bump_run(h_branch, q_in, 0.004, 5000)
    assert h0[x < 5].min() > hc and h0[x > 15].max() < hc
    assert np.isfinite(h1).all()
    rel = np.abs(h1 - h0) / h0
    assert rel.max() < 0.06, f"max rel depth drift {rel.max():.4f}"
    assert np.abs(hu1 - q_in).max() / q_in < 0.06
