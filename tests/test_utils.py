import json
import numpy as np
import jax.numpy as jnp
import pytest

from tomojax.utils import io, config, profiling
from tomojax.core.geometry import Views


def test_h5_dataset_roundtrip(tmp_path):
    path = str(tmp_path / "ds.h5")
    n_proj, nu, nv = 5, 8, 8
    rng = np.random.default_rng(0)
    proj = rng.random((n_proj, nu, nv)).astype(np.float32)
    phi = np.linspace(0, np.pi, n_proj)
    alpha = rng.random(n_proj)
    beta = rng.random(n_proj)
    xyz = rng.random((n_proj, 3))
    ph = rng.random((8, 8, 8)).astype(np.float32)
    io.save_dataset(path, projections=proj, phi=phi, alpha=alpha, beta=beta,
                    xyz=xyz, phantom=ph)
    d = io.load_dataset(path)
    np.testing.assert_array_equal(d["projections"], proj)
    np.testing.assert_array_equal(d["phantom"], ph)
    views = io.views_from_dataset(d)
    assert views.n_proj == n_proj
    np.testing.assert_allclose(views.t, xyz, rtol=1e-6)


def test_config_roundtrip(tmp_path):
    cfg = config.ExperimentConfig()
    cfg.solver.method = "cgls"
    cfg.solver.niter = 42
    cfg.align.param_set = "xzb"
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    back = config.ExperimentConfig.from_json(path)
    assert back.solver.method == "cgls"
    assert back.solver.niter == 42
    assert back.align.param_set == "xzb"
    # geometry builds
    geom = back.geometry.build()
    assert geom.n_proj == 90


def test_config_from_json_string():
    s = json.dumps({"solver": {"method": "fista_tv", "beta_tv": 0.5}})
    cfg = config.ExperimentConfig.from_json(s)
    assert cfg.solver.method == "fista_tv"
    assert cfg.solver.beta_tv == 0.5


def test_timed_helper():
    f = lambda x: jnp.sum(x * 2)
    out, dt = profiling.timed(f, jnp.ones(16), reps=2)
    assert float(out) == 32.0
    assert dt >= 0.0


def test_cli_simulate_reconstruct(tmp_path):
    from tomojax.cli import main
    ds = str(tmp_path / "d.h5")
    rec = str(tmp_path / "r.npy")
    main(["simulate", "--size", "16", "--views", "8", "-o", ds])
    main(["reconstruct", "-i", ds, "-o", rec])
    vol = io.load_volume(rec)
    assert vol.shape == (16, 16, 16)
    assert np.isfinite(vol).all()


def test_npz_dataset_roundtrip(tmp_path):
    """The .npz dataset keeps the reference's data/* layout and dtypes."""
    path = str(tmp_path / "ds.npz")
    rng = np.random.default_rng(1)
    fields = {"projections": rng.random((3, 6, 5)).astype(np.float32),
              "phi": np.linspace(0, np.pi, 3), "alpha": rng.random(3),
              "beta": rng.random(3), "xyz": rng.random((3, 3))}
    io.save_dataset(path, phantom=rng.random((6, 6, 5)).astype(np.float32),
                    **fields)
    d = io.load_dataset(path)
    assert set(d) == set(fields) | {"phantom"}
    for k, v in fields.items():
        np.testing.assert_array_equal(d[k], v)
        assert d[k].dtype == v.dtype
    with np.load(path) as z:
        assert "data/projections" in z.files


def test_cli_simulate_reconstruct_npz(tmp_path):
    from tomojax.cli import main
    ds = str(tmp_path / "d.npz")
    rec = str(tmp_path / "r.npy")
    main(["simulate", "--size", "16", "--views", "8",
          "--set", "simulate.family=slab", "-o", ds])
    main(["reconstruct", "-i", ds, "-o", rec, "--pre-align", "com",
          "--set", "solver.method=cgls", "--set", "solver.niter=5",
          "--set", "solver.family=slab_plane"])
    vol = io.load_volume(rec)
    assert vol.shape == (16, 16, 16)
    assert np.isfinite(vol).all()


def test_compilation_cache_dir_default_in_checkout(monkeypatch):
    import os
    import tomojax
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tomojax.__file__)))
    assert tomojax.compilation_cache_dir() == os.path.join(root,
                                                           ".jax_cache")


def test_compilation_cache_dir_follows_variable(monkeypatch, tmp_path):
    import tomojax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert tomojax.compilation_cache_dir() == str(tmp_path)


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py measures the GPU: on the CPU its device phase exits
    (non-zero) naming the missing GPU."""
    import chip_smoke
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.device_phase()
