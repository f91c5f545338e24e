"""The torch port as a package: it never imports jax or the JAX package,
and its mirrored flag table and synthetic generator equal the JAX ones."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
from pstl_tpu.config import Config as JConfig
from pstl_tpu.data import synthetic as jsyn
from pstl_tpu_torch.config import Config as TConfig, bench_config
from pstl_tpu_torch.data import synthetic as tsyn
from pstl_tpu_torch.ops import _build

import torch_parity  # noqa: F401  (torch thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pstl_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pstl_tpu")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_package_imports_no_jax_ast():
    """No module of the port (nor chip_smoke.py, the port's e2e script, or
    the test helpers the card's host runs) names jax, flax, optax, orbax or the JAX package in an
    import."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "e2e_pipeline_torch.py"),
             os.path.join(REPO, "tests", "torch_devkit_shim.py"),
             os.path.join(REPO, "tests", "torch_parallel_case.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append((os.path.relpath(f, REPO), mod))
    assert not bad, bad


def test_package_import_loads_no_jax():
    """Importing the port (its entry modules) loads no jax, even
    indirectly."""
    code = ("import pstl_tpu_torch, pstl_tpu_torch.sim, "
            "pstl_tpu_torch.train, pstl_tpu_torch.losses, "
            "pstl_tpu_torch.trajopt, pstl_tpu_torch.metrics, "
            "pstl_tpu_torch.eval_openloop, "
            "pstl_tpu_torch.data.dataset, pstl_tpu_torch.diffusion, "
            "pstl_tpu_torch.runtime, pstl_tpu_torch.runtime.shard_store, "
            "pstl_tpu_torch.ops.clearance_kernel, "
            "pstl_tpu_torch.models.convert, pstl_tpu_torch.models.rdt, "
            "pstl_tpu_torch.models.unet1d, pstl_tpu_torch.cli, "
            "pstl_tpu_torch.viz, pstl_tpu_torch.parallel, "
            "pstl_tpu_torch.data.extract; import sys; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_package_imports_without_matplotlib():
    """With matplotlib and PIL missing (as on the card's host), the command
    line, viz and the modules whose hooks draw still import, and import
    neither."""
    code = ("import sys; sys.modules.update({m: None for m in ("
            "'matplotlib', 'matplotlib.pyplot', 'PIL', 'PIL.Image')}); "
            "import pstl_tpu_torch.cli, pstl_tpu_torch.viz, "
            "pstl_tpu_torch.train, pstl_tpu_torch.sim, "
            "pstl_tpu_torch.eval_openloop; "
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "m.split('.')[0] in ('matplotlib', 'PIL')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_config_fields_and_defaults_mirror_jax():
    jf = {f.name: (f.default, str(f.type)) for f in dataclasses.fields(
        JConfig)}
    tf = {f.name: (f.default, str(f.type)) for f in dataclasses.fields(
        TConfig)}
    assert list(jf) == list(tf)
    assert jf == tf


@pytest.mark.parametrize("open_loop", [False, True])
@pytest.mark.parametrize("guidance", [True, False])
def test_ref_parity_mirrors_jax(guidance, open_loop):
    """Config.ref_parity gives, field for field, the JAX method's bundle,
    from a configuration whose every reverted field is off its parity
    value."""
    flags = dict(diffusion=True, rect_head=True, diverse_loss=True,
                 multi_cands=7, guidance=guidance, guidance_niters=3,
                 guidance_before=40, guidance_lr=0.2, n_rolls=3, flex=True)
    j = JConfig(**flags).finalize().with_(
        forward_shield=True, env_nonnegative_speed=True,
        sample_noise_scale=1.3, backup_niters=100)
    t = TConfig(**j.to_dict())
    want = j.ref_parity(open_loop=open_loop).to_dict()
    assert t.ref_parity(open_loop=open_loop).to_dict() == want
    assert t.ref_parity(open_loop).to_dict() != t.to_dict()
    assert TConfig().ref_parity().to_dict() == JConfig().ref_parity(
        ).to_dict()


@pytest.mark.parametrize("mode", ["heavy", "parity", "parity_nog"])
def test_bench_configs_finalize_equal(mode, monkeypatch):
    """bench.build_cfg(mode) (every BENCH_* knob unset) and the port's
    bench_config(mode) finalize to equal field dicts; so do the same flags
    given to both Config classes."""
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    assert bench.build_cfg(mode).to_dict() == bench_config(mode).to_dict()
    flags = dict(diffusion=True, rect_head=True, diverse_loss=True,
                 multi_cands=10, guidance=True, n_rolls=3,
                 guidance_pallas_pack=2, clearance_coarse_pair=True,
                 flex=True)
    assert (JConfig(**flags).finalize().to_dict()
            == TConfig(**flags).finalize().to_dict())


def _bench_env(monkeypatch, **env):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("mode", ["heavy", "parity", "parity_nog"])
@pytest.mark.parametrize("gpallas", ["0", "1", "1f", "2f", "2", "3", "4"],
                         ids=["0", "1", "1f", "2f", "2", "fold2",
                              "superstep"])
def test_bench_gpallas_configs_equal(mode, gpallas, monkeypatch):
    """bench.build_cfg(mode) with BENCH_GPALLAS=gpallas equals
    bench_config(mode, gpallas=...), field for field."""
    _bench_env(monkeypatch, BENCH_GPALLAS=gpallas)
    want = bench.build_cfg(mode).to_dict()
    got = bench_config(mode, gpallas=gpallas)
    assert got.to_dict() == want
    assert got.guidance_pallas == (gpallas != "0")
    assert got.guidance_pallas_fuse_freeze == (gpallas in ("2", "2f", "3",
                                                            "4"))
    assert got.guidance_pallas_fold == gpallas.endswith("f")
    if gpallas in ("3", "4"):
        assert got.guidance_pallas_fold2
        assert got.guidance_pallas_superstep == (gpallas == "4")


@pytest.mark.parametrize("gpallas,knobs", [
    ("1", dict(sel_every=2)), ("0", dict(sel_every=3)),
    ("1f", dict(geometry_dtype="bfloat16")),
    ("0", dict(geometry_dtype="bfloat16"))],
    ids=["sel2", "xla_sel3", "geom_bf16", "xla_geom_bf16"])
def test_bench_sel_every_geometry_configs_equal(gpallas, knobs, monkeypatch):
    """BENCH_SEL_EVERY and BENCH_GEOM_DTYPE mirror bench_config's
    sel_every and geometry_dtype."""
    env = {"BENCH_GPALLAS": gpallas}
    if "sel_every" in knobs:
        env["BENCH_SEL_EVERY"] = str(knobs["sel_every"])
    if "geometry_dtype" in knobs:
        env["BENCH_GEOM_DTYPE"] = knobs["geometry_dtype"]
    _bench_env(monkeypatch, **env)
    got = bench_config("heavy", gpallas=gpallas, **knobs)
    assert got.to_dict() == bench.build_cfg("heavy").to_dict()
    assert got.guidance_sel_every == knobs.get("sel_every", 1)
    assert got.geometry_dtype == knobs.get("geometry_dtype", "float32")


def test_bench_gpallas_unported_raise(monkeypatch):
    """An unknown BENCH_GPALLAS value raises; the fused kernel with a
    selection carry is refused by both packages' finalize, as bench.py's
    row with BENCH_SEL_EVERY=2 is."""
    with pytest.raises(ValueError):
        bench_config("heavy", gpallas="5")
    _bench_env(monkeypatch, BENCH_GPALLAS="2", BENCH_SEL_EVERY="2")
    with pytest.raises(ValueError):
        bench.build_cfg("heavy").finalize()
    with pytest.raises(ValueError):
        bench_config("heavy", gpallas="2", sel_every=2).finalize()


def test_build_hash_covers_headers(tmp_path):
    """The build directory's hash changes with the .cu, with any header
    under csrc/ (a .cu may include it) and with nothing else there."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("a\n")
    h0 = _build.source_hash("k", str(tmp_path))
    assert _build.source_hash("k", str(tmp_path)) == h0
    (tmp_path / "notes.txt").write_text("b\n")
    assert _build.source_hash("k", str(tmp_path)) == h0
    (tmp_path / "shared.cuh").write_text("// v2\n")
    h1 = _build.source_hash("k", str(tmp_path))
    assert h1 != h0
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edit\n')
    assert _build.source_hash("k", str(tmp_path)) not in (h0, h1)
    # the repo's kernels share guidance_device.cuh
    src = open(os.path.join(_build.CSRC_DIR, "superstep.cu")).read()
    assert '#include "guidance_device.cuh"' in src


def test_finalize_rejections_mirror_jax():
    for kw in (dict(guidance_pallas_pack=2, guidance_pallas_fold2=True),
               dict(guidance_pallas_fuse_freeze=True, guidance_sel_every=2),
               dict(guidance_pallas=True, robustness_dtype="bfloat16"),
               dict(guidance_pallas_superstep=True, cm_sampler=False)):
        with pytest.raises(ValueError):
            JConfig(**kw).finalize()
        with pytest.raises(ValueError):
            TConfig(**kw).finalize()


@pytest.mark.parametrize("t_samples", [1, 3])
def test_synthetic_dataset_bit_identical(t_samples):
    """generate_dataset is a line-for-line numpy mirror: same draws, same
    arrays, key for key."""
    kw = dict(n_randoms=4, n_neighbors=8, synth_low_speed_frac=0.3)
    a = jsyn.generate_dataset(0, 4, JConfig(**kw), scene_len=38,
                              t_samples=t_samples)
    b = tsyn.generate_dataset(0, 4, TConfig(**kw), scene_len=38,
                              t_samples=t_samples)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
