"""BASELINE config 3: 256^3 phantom with random rigid perturbations —
FFT cross-correlation pre-alignment + CGLS reconstruction, recorded.

Reference semantics being matched: `align/align_cc.py` (the reference's
standalone coarse-alignment library — translation-only, no gradient
refinement) feeding a CGLS reconstruction (`recon/cgls.py`).  The
perturbations here are therefore translations (tx, tz); the 6-DoF case
with tilts is BASELINE config 4 (`examples/convergence_study.py`).

Pre-alignment methods recorded side by side:
  * ``com_align``    — sinogram first-moment consistency (drift-free;
                       beyond the reference, see align/cc.py:244-299)
  * ``cc chain``     — reference-style sequential pairwise subpixel PCC
                       (`align_cc.py:27-38`), whose rotation-induced
                       chain drift the gauge fit removes only partially.

Data is generated with the slab-arc production operator and solved with
the same operator — the reference's own protocol (its driver generates
data with the identical ProjectionMatrix it reconstructs with,
`examples/generate_data.py:25-29`).

Output: JSON with per-method (tx, tz) error tables (raw + gauge-
corrected), CGLS rel-L2 trajectories (misaligned / pre-aligned / true
params), and wall-clock per stage, at --size 256.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=180)
    ap.add_argument("--jitter-px", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cgls-iters", type=int, default=60)
    ap.add_argument("--cgls-chunk", type=int, default=20)
    ap.add_argument("--quad", default="arc", choices=["arc", "plane"])
    ap.add_argument("--out", default="docs/convergence/config3_256.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import phantom
    from tomojax.core import slab_projector as sp
    from tomojax.align import com_align, cross_correlation_chain
    from tomojax.core.operators import make_operator
    from tomojax.recon.cgls import cgls

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    vol = jnp.asarray(phantom.shepp3d(n).astype(np.float32))
    rng = np.random.default_rng(args.seed)
    phi = np.linspace(0.0, np.pi, n_proj)
    tx = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    tz = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    t_true = np.zeros((n_proj, 3))
    t_true[:, 0], t_true[:, 2] = tx, tz
    views_true = Views.create(n_proj, phi=phi, t=t_true)

    rec = {"config": vars(args), "stages": {}}
    t0 = time.perf_counter()

    print(f"[gen] slab-{args.quad} projection of {n}^3, {n_proj} views "
          f"(±{args.jitter_px} px translations)", flush=True)
    proj = sp.project(vol, geom, views_true, quad=args.quad)
    jax.block_until_ready(proj)
    rec["stages"]["gen_s"] = time.perf_counter() - t0
    print(f"[gen] done in {rec['stages']['gen_s']:.1f}s", flush=True)

    def err_table(est_tx, est_tz, relative=False):
        """Raw + gauge-corrected error stats (gauge: tx ~ {cos,sin}phi
        volume shift, tz ~ const — see examples/convergence_study.py).

        ``relative=True`` additionally removes the error means (chain
        methods only promise alignment relative to view 0; the constant
        tx component — the COR mode — is not in the gauge basis)."""
        etx = np.asarray(est_tx, np.float64) - tx
        etz = np.asarray(est_tz, np.float64) - tz
        if relative:
            etx = etx - etx.mean()
            etz = etz - etz.mean()
        c, s = np.cos(phi), np.sin(phi)
        A = np.stack([c, s], 1)
        coef, *_ = np.linalg.lstsq(A, etx, rcond=None)
        etx_gc = etx - A @ coef
        etz_gc = etz - etz.mean()
        st = lambda e: {"mean": float(np.abs(e).mean()),
                        "max": float(np.abs(e).max())}
        return {"raw": {"tx": st(etx), "tz": st(etz)},
                "gauge_corrected": {"tx": st(etx_gc), "tz": st(etz_gc)}}

    # --- pre-alignment methods -------------------------------------
    t1 = time.perf_counter()
    est = np.asarray(com_align(proj, geom, phi))
    com_s = time.perf_counter() - t1
    rec["stages"]["com"] = {**err_table(est[:, 0], est[:, 1]),
                            "wall_s": com_s}
    print(f"[com] {com_s:.1f}s "
          f"tx gc-mean {rec['stages']['com']['gauge_corrected']['tx']['mean']:.3e}",
          flush=True)

    t1 = time.perf_counter()
    sino = jnp.asarray(proj).reshape(n_proj, n, n)  # (view, u, v)
    offsets, _ = cross_correlation_chain(sino)
    offsets = np.asarray(offsets)
    # offsets[i] ≈ (tx_i − tx_0, tz_i − tz_0) + rotation-induced drift:
    # the chain estimates translations relative to view 0 (axis order
    # (u, v) matches com_align's sinogram layout)
    cc_s = time.perf_counter() - t1
    rec["stages"]["cc_chain"] = {**err_table(offsets[:, 0], offsets[:, 1],
                                             relative=True),
                                 "wall_s": cc_s}
    print(f"[cc ] {cc_s:.1f}s "
          f"tx gc-mean {rec['stages']['cc_chain']['gauge_corrected']['tx']['mean']:.3e}",
          flush=True)

    # --- CGLS reconstructions ---------------------------------------
    fam = "slab" if args.quad == "arc" else "slab_plane"

    def run_cgls(t_est, label):
        v = Views.create(n_proj, phi=phi, t=np.asarray(t_est, np.float32))
        op = make_operator(geom, v, family=fam)
        x = jnp.zeros(geom.vox_shape, jnp.float32)
        t1 = time.perf_counter()
        rels = []
        left = args.cgls_iters
        while left > 0:
            k = min(args.cgls_chunk, left)
            res = cgls(op, proj, niter=k, x0=x)
            x = res.x
            left -= k
            rel = float(np.linalg.norm(np.asarray(x, np.float64).ravel()
                                       - np.asarray(vol, np.float64).ravel())
                        / np.linalg.norm(np.asarray(vol, np.float64)))
            rels.append(rel)
            print(f"[{label}] cgls {args.cgls_iters - left}/"
                  f"{args.cgls_iters}: rel-L2 {rel:.4f} "
                  f"(t={time.perf_counter() - t1:.1f}s)", flush=True)
        return {"rel_l2": rels, "wall_s": time.perf_counter() - t1}

    t_com = np.zeros((n_proj, 3), np.float32)
    t_com[:, 0], t_com[:, 2] = est[:, 0], est[:, 1]
    # CC-chain estimates: the reference's own pre-alignment
    # (`align_cc.py:27-38` feeding recon) — offsets are relative to view
    # 0; remove the mean (a pure gauge/COR component) before use
    t_cc = np.zeros((n_proj, 3), np.float32)
    t_cc[:, 0] = offsets[:, 0] - offsets[:, 0].mean()
    t_cc[:, 2] = offsets[:, 1] - offsets[:, 1].mean()
    rec["stages"]["cgls_misaligned"] = run_cgls(np.zeros((n_proj, 3)),
                                                "mis")
    rec["stages"]["cgls_com"] = run_cgls(t_com, "com")
    rec["stages"]["cgls_cc"] = run_cgls(t_cc, "cc")
    rec["stages"]["cgls_true"] = run_cgls(t_true, "true")

    rec["total_wall_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
