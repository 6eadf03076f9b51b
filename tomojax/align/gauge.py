"""Parameter errors up to the joint problem's rigid gauge.

The joint problem is invariant under a rigid motion of the volume. To
first order a global volume shift (dx, dy, dz) and tilt (wx, wy) map
exactly onto per-view parameter offsets

    tx_i ->  tx_i + cos(phi_i) dx + sin(phi_i) dy
    tz_i ->  tz_i + dz
    a_i  ->  a_i  + cos(phi_i) wx + sin(phi_i) wy
    b_i  ->  b_i  - sin(phi_i) wx + cos(phi_i) wy

so the cost cannot distinguish them. The random ground-truth jitter has a
nonzero projection onto this 5-dim gauge subspace (~sigma/sqrt(n_views)),
which raw per-view errors can never beat, so errors are reported both raw
and after removing the best-fit gauge component (the scientifically
meaningful residual).
"""

from __future__ import annotations

import numpy as np


def gauge_fit(phi, tx_err, tz_err, a_err, b_err):
    """Least-squares fit of the 5 gauge parameters to per-view param errors.

    Returns (gauge dict, corrected (tx, tz, a, b) error arrays)."""
    c, s = np.cos(phi), np.sin(phi)
    # tx block: [c s] @ [dx dy]
    Atx = np.stack([c, s], 1)
    dxy, *_ = np.linalg.lstsq(Atx, tx_err, rcond=None)
    tz_off = float(tz_err.mean())
    # angle block: a ~ [c s] w ; b ~ [-s c] w  (joint fit)
    Aab = np.concatenate([np.stack([c, s], 1), np.stack([-s, c], 1)], 0)
    yab = np.concatenate([a_err, b_err])
    w, *_ = np.linalg.lstsq(Aab, yab, rcond=None)
    tx_c = tx_err - Atx @ dxy
    tz_c = tz_err - tz_off
    a_c = a_err - np.stack([c, s], 1) @ w
    b_c = b_err - np.stack([-s, c], 1) @ w
    gauge = {"dx": float(dxy[0]), "dy": float(dxy[1]), "dz": tz_off,
             "wx": float(w[0]), "wy": float(w[1])}
    return gauge, (tx_c, tz_c, a_c, b_c)


def param_errors(views, truth, phi):
    tx_err = np.asarray(views.t)[:, 0] - truth["tx"]
    tz_err = np.asarray(views.t)[:, 2] - truth["tz"]
    a_err = np.asarray(views.alpha) - truth["alpha"]
    b_err = np.asarray(views.beta) - truth["beta"]
    gauge, (txc, tzc, ac, bc) = gauge_fit(phi, tx_err, tz_err, a_err, b_err)

    def stats(e):
        return {"mean": float(np.abs(e).mean()), "max": float(np.abs(e).max())}

    return {
        "raw": {"tx": stats(tx_err), "tz": stats(tz_err),
                "alpha": stats(a_err), "beta": stats(b_err)},
        "gauge_corrected": {"tx": stats(txc), "tz": stats(tzc),
                            "alpha": stats(ac), "beta": stats(bc)},
        "gauge": gauge,
    }


def vol_error(volume, phantom):
    v = np.asarray(volume, np.float64).reshape(phantom.shape)
    p = np.asarray(phantom, np.float64)
    return float(np.linalg.norm(v - p) / np.linalg.norm(p))
