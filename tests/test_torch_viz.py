"""``pstl_tpu_torch.viz`` against ``pstl_tpu.viz``: the cases of
``tests/test_viz.py`` through the port, and every drawing of both packages
on the same seeded inputs decoded to pixel arrays that are equal to the bit
(PNGs), frame by frame (GIFs)."""

import os

import numpy as np
import pytest
from PIL import Image

from pstl_tpu import viz as jviz
from pstl_tpu_torch import viz as tviz
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.data import synthetic


def pixels(path):
    """Every frame of an image file as uint8 arrays."""
    with Image.open(path) as im:
        frames = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGBA")))
    return frames


def same_pixels(a, b):
    fa, fb = pixels(a), pixels(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.shape == y.shape and np.array_equal(x, y)


@pytest.fixture(scope="module")
def scene_np():
    cfg = Config(n_randoms=2, n_neighbors=2)
    data = synthetic.generate_dataset(0, 2, cfg, scene_len=12)
    return cfg, data


def _fans(data, cfg, seed=0, M=3):
    rng = np.random.RandomState(seed)
    trajs = np.cumsum(rng.randn(M, 3, cfg.nt, 4) * 0.3, axis=2) \
        + data["ego_traj"][0, 0, :4]
    return trajs, rng.randn(M, 3)


def _raster(data):
    """Per-sample drivable rasters, as the train / eval hooks inject them
    from the per-scene store through traj_i."""
    d = dict(data)
    ti = np.asarray(data["traj_i"]).astype(int).reshape(-1)
    drv = np.zeros((2, 40, 40), bool)
    drv[:, 15:25, :] = True
    d["scene_drivable"] = drv[ti]
    d["scene_drivable_origin"] = np.tile(
        data["ego_traj"][:1, 0, :2] - 10.0, (len(ti), 1)).astype(np.float32)
    d["scene_drivable_res"] = np.full((len(ti),), 0.5, np.float32)
    return d


def test_plot_scene_with_candidates(scene_np, tmp_path):
    cfg, data = scene_np
    rng = np.random.RandomState(0)
    cand = rng.randn(3, 3, cfg.nt, 2).astype(np.float32) * 5
    cand[..., 0] += data["ego_traj"][0, 0, 0]
    cand[..., 1] += data["ego_traj"][0, 0, 1]
    scores = rng.randn(3, 3).astype(np.float32)
    paths = []
    for pkg in (tviz, jviz):
        paths.append(str(tmp_path / f"scene_{pkg.__name__}.png"))
        pkg.save_scene(paths[-1], data, 0, cand_trajs=cand,
                       cand_scores=scores, title="test")
    assert os.path.getsize(paths[0]) > 1000
    same_pixels(*paths)


def test_control_histograms(scene_np, tmp_path):
    cfg, _ = scene_np
    controls = np.random.RandomState(1).randn(100, cfg.nt, 2)
    paths = []
    for pkg in (tviz, jviz):
        paths.append(str(tmp_path / f"hist_{pkg.__name__}.png"))
        pkg.plot_control_histograms(controls, paths[-1])
    assert os.path.exists(paths[0])
    same_pixels(*paths)


def test_closed_loop_frame_and_gif(scene_np, tmp_path):
    cfg, data = scene_np
    gifs = []
    for pkg in (tviz, jviz):
        frames = []
        for t in range(2):
            p = str(tmp_path / f"f{t}_{pkg.__name__}.png")
            pkg.render_closed_loop_frame(
                p, data["scene_center_dense"][0],
                data["scene_lane_valids"][0],
                data["scene_ego_full"][0, :t + 2],
                data["scene_nei_full"][0, :, t],
                data["scene_ego_full"][0, t:t + 5],
                drivable=np.ones((40, 40), bool) if t else None,
                drivable_origin=data["scene_ego_full"][0, 0, :2] - 10.0)
            frames.append(p)
        gifs.append(str(tmp_path / f"ep_{pkg.__name__}.gif"))
        pkg.generate_gif(gifs[-1], frames)
    assert os.path.getsize(gifs[0]) > 100
    for t in range(2):
        same_pixels(str(tmp_path / f"f{t}_pstl_tpu_torch.viz.png"),
                    str(tmp_path / f"f{t}_pstl_tpu.viz.png"))
    assert len(pixels(gifs[0])) == 2
    same_pixels(*gifs)


@pytest.mark.parametrize("raster", [False, True], ids=["lanes", "raster"])
def test_paper_and_training_viz(tmp_path, raster):
    cfg = Config(n_neighbors=2, n_randoms=2)
    data = synthetic.generate_dataset(0, 2, cfg, scene_len=24)
    if raster:
        data = _raster(data)
    trajs, scores = _fans(data, cfg)
    for what in ("paper", "train"):
        paths = []
        for pkg in (tviz, jviz):
            paths.append(str(tmp_path / f"{what}_{pkg.__name__}.png"))
            if what == "paper":
                pkg.plot_paper_scene(paths[-1], data, 0, nn_trajs=trajs,
                                     nn_scores=scores)
            else:
                pkg.plot_training_viz(paths[-1], data, 0, tj_trajs=trajs,
                                      tj_scores=scores, nn_trajs=trajs,
                                      nn_scores=scores, epoch=3)
        assert os.path.getsize(paths[0]) > 5000
        same_pixels(*paths)


def test_without_matplotlib_viz_imports_and_calls_name_it(monkeypatch):
    """With matplotlib and PIL missing the module still works as a module;
    a drawing call raises the ImportError that names the package."""
    import sys
    for mod in ("matplotlib", "matplotlib.pyplot", "PIL"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError, match="matplotlib"):
        tviz.plot_control_histograms(np.zeros((2, 3, 2)), "x.png")
    with pytest.raises(ImportError, match="PIL"):
        tviz.generate_gif("x.gif", [])
