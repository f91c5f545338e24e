"""End-to-end pipeline of the torch port on synthetic scenes: the
counterpart of ``scripts/e2e_pipeline.py`` (the reference's e0->e1->...->e8
staged workflow, README.md:54-202), with the same stages, environment
controls and ``results.json`` keys:

  1. generate scenes (e0) — multi-(scene, t) samples per scene
  2. trajopt augmentation (e1)
  3. train every method family:
       e5  plain DDPM (augmented)          e7  ours (RefineNet + DPP)
       e2  VAE mono    e3 VAE (augmented)  e4  DDPM mono
       e6  TrafficSim (VAE + collision)
  4. open-loop eval (Table-I rows) for each method (+ CTG, + ours+guidance)
  5. closed-loop eval (Table-II rows) on the held-out 25-scene protocol
  6. save the e7 checkpoint (``models``)

    python scripts/e2e_pipeline_torch.py

Writes ``$E2E_OUT`` (default exps/e2e_torch): cache_aug.npz, models_*/
(port checkpoints), viz_*/ and results.json.  A stage whose output exists
is skipped, so the stages can run one process at a time.  Stage control:
E2E_STAGES=data,train,eval,sim (default all); method control:
E2E_METHODS=e5,e7,... (default all); sizes: E2E_SCENES, E2E_T_SAMPLES,
E2E_TJ_ITERS, E2E_EPOCHS_E5 / _E7 / _BASE; E2E_E5_INIT (weights e5 starts
from: a port checkpoint or a flat flax .npz), E2E_E7_DIVERSITY,
E2E_LOW_SPEED.  E2E_DEVICE: where it runs (default the card; "cpu" runs
the plain versions on the CPU).  Without matplotlib the Table-I figures
are not drawn, and the log says so.
"""

import importlib.util
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from pstl_tpu_torch import diffusion, eval_openloop, specs, train, trajopt
from pstl_tpu_torch.config import PRESETS
from pstl_tpu_torch.data.dataset import SceneDataset
from pstl_tpu_torch.device import resolve_device
from pstl_tpu_torch.models.net import Net

OUT = os.environ.get("E2E_OUT", "exps/e2e_torch")
T0 = time.time()
#: every preset's width and batch (the JAX script's ``base``)
BASE = dict(n_randoms=64, n_neighbors=8, batch_size=16)
#: Table I: candidates a (scene, maneuver) and val batches after the first
SAMPLING_SIZE = 64
EVAL_TRIALS = 3
#: Table II: held-out scenes and steps an episode
N_TEST = 25
SIM_STEPS = 36


def log(msg):
    print(f"[{time.time()-T0:8.1f}s] {msg}", flush=True)


def save_results(results):
    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump(results, f, indent=2)


def main():
    os.makedirs(os.path.join(OUT, "models"), exist_ok=True)
    dev = resolve_device(os.environ.get("E2E_DEVICE") or None)
    n_scenes = int(os.environ.get("E2E_SCENES", "768"))
    t_samples = int(os.environ.get("E2E_T_SAMPLES", "3"))
    epochs_e5 = int(os.environ.get("E2E_EPOCHS_E5", "150"))
    epochs_e7 = int(os.environ.get("E2E_EPOCHS_E7", "25"))
    epochs_base = int(os.environ.get("E2E_EPOCHS_BASE", "80"))
    tj_iters = int(os.environ.get("E2E_TJ_ITERS", "2000"))
    stages = os.environ.get("E2E_STAGES", "data,train,eval,sim").split(",")
    methods = os.environ.get(
        "E2E_METHODS", "e5,e7,e2,e3,e4,e6").split(",")
    log(f"device {dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
           else ""))

    def preset(name, **kw):
        return PRESETS[name].with_(**BASE).with_(**kw)

    cfg5 = preset("e5_ddpm").with_(epochs=epochs_e5)
    cfg7 = preset("e7_ours").with_(epochs=epochs_e7)

    results = {}
    if os.path.exists(os.path.join(OUT, "results.json")):
        results = json.load(open(os.path.join(OUT, "results.json")))

    # ---- 1+2. data + trajopt -------------------------------------------
    cache = os.path.join(OUT, "cache_aug.npz")
    if os.path.exists(cache):
        ds = SceneDataset.load(cache, cfg5)
        log(f"loaded cached dataset ({len(ds)} samples)")
    else:
        if "data" not in stages:
            raise SystemExit("no cache and data stage disabled")
        from pstl_tpu_torch.data import synthetic
        # E2E_LOW_SPEED: fraction of near-stop/low-speed scenes mixed into
        # the TRAINING data only; the held-out closed-loop protocol below
        # stays unchanged
        low_speed = float(os.environ.get("E2E_LOW_SPEED", "0"))
        data = synthetic.generate_dataset(
            cfg5.seed, n_scenes,
            cfg5.with_(synth_low_speed_frac=low_speed), scene_len=38,
            t_samples=t_samples, t_stride=6)
        ds = SceneDataset(data, cfg5)
        log(f"generated {len(ds)} samples from {n_scenes} scenes")
        formulas = specs.build_scorer(cfg5)
        t_tj = time.time()
        trajopt.augment_dataset(ds, cfg5, formulas, batch_size=64,
                                iters=tj_iters, verbose=True, device=dev,
                                log=log)
        sc = ds.data["tj_scores_prior"]
        log(f"trajopt done in {time.time() - t_tj:.1f} s: sat-rate "
            f"{float((sc > 0).mean()):.3f}")
        ds.save(cache)
    results["trajopt_sat"] = float((ds.data["tj_scores_prior"] > 0).mean())
    save_results(results)

    # ---- 3. training ------------------------------------------------------
    e5_init = os.environ.get("E2E_E5_INIT")   # warm-start lineage
    div_w = os.environ.get("E2E_E7_DIVERSITY")  # entropy lever sweep
    if e5_init:
        cfg5 = cfg5.with_(net_pretrained_path=e5_init)
    if div_w:
        cfg7 = cfg7.with_(diversity_weight=float(div_w))
    TRAIN_CFGS = {
        "e5": cfg5,
        "e7": cfg7.with_(net_pretrained_path=os.path.join(OUT, "models_e5")),
        "e2": preset("e2_vae_mono").with_(epochs=epochs_base),
        "e3": preset("e3_vae").with_(epochs=epochs_base),
        "e4": preset("e4_ddpm_mono").with_(epochs=epochs_base),
        "e6": preset("e6_trafficsim").with_(epochs=epochs_base),
    }
    if "train" in stages:
        for m in methods:
            cfgm = TRAIN_CFGS[m]
            mdir = os.path.join(OUT, f"models_{m}")
            if os.path.exists(os.path.join(mdir, "LAST")):
                log(f"train {m}: checkpoint exists, skipping")
                continue
            log(f"training {m} ({cfgm.epochs} epochs)...")
            t_tr = time.time()
            st = train.train(cfgm.with_(exp_name=None), ds, log=log,
                             device=dev)
            train.save_checkpoint(mdir, st, 0)
            log(f"train {m}: done in {time.time() - t_tr:.1f} s")
        # the serving checkpoint = e7
        if "e7" in methods:
            train.save_checkpoint(os.path.join(OUT, "models"),
                                  _load(cfg7, os.path.join(OUT, "models_e7"),
                                        dev), 0)

    # ---- 4. open-loop eval (Table I) --------------------------------------
    # eval always runs the multi-candidate path: the reference's eval
    # commands for the mono-trained models drop --gt_data_training
    # (README.md:135-144)
    EVAL_CFGS = {
        "vae_mono": ("e2", preset("e2_vae_mono",
                                  gt_data_training=False)),
        "vae_aug": ("e3", preset("e3_vae")),
        "ddpm_mono": ("e4", preset("e4_ddpm_mono",
                                   gt_data_training=False)),
        "ddpm_aug": ("e5", preset("e5_ddpm")),
        "trafficsim": ("e6", preset("e6_trafficsim")),
        "ctg": ("e5", preset("ctg")),
        "ours": ("e7", preset("e7_ours").with_(n_rolls=3)),
        "ours_guidance": ("e7", preset("ours_guidance")),
    }
    if "eval" in stages:
        draw = importlib.util.find_spec("matplotlib") is not None
        if not draw:
            log("matplotlib is not installed: the Table-I figures "
                "(viz_dir) are not drawn")
        for row, (m, cfge) in EVAL_CFGS.items():
            if m not in methods:
                continue
            mdir = os.path.join(OUT, f"models_{m}")
            if not os.path.exists(os.path.join(mdir, "LAST")):
                log(f"eval {row}: no checkpoint, skipping")
                continue
            log(f"open-loop eval: {row}")
            cfge = cfge.with_(test=True, sampling_size=SAMPLING_SIZE,
                              **BASE)
            st = _load(cfge, mdir, dev)
            out = eval_openloop.run(
                cfge, ds, st.net, n_trials=EVAL_TRIALS, log=log,
                viz_dir=os.path.join(OUT, f"viz_{row}") if draw else None,
                device=dev)
            results[f"openloop_{row}"] = {k: round(v, 4)
                                          for k, v in out.items()}
            save_results(results)

    # ---- 5. closed-loop eval (Table II) ------------------------------------
    if "sim" in stages:
        from pstl_tpu_torch import sim as simmod
        from pstl_tpu_torch.data import synthetic
        data = synthetic.generate_dataset(777, N_TEST * 2, cfg5,
                                          scene_len=38)
        keep = np.where(data["scene_ego_full"][:, :, 3].mean(-1)
                        >= 1.0)[0][:N_TEST]
        data = {k: v[keep] for k, v in data.items()}
        scenes = simmod.scenes_from_dataset(data, device=dev)
        SIM_CFGS = {
            "vae_aug": ("e3", preset("e3_vae")),
            "ddpm_aug": ("e5", preset("e5_ddpm")),
            "trafficsim": ("e6", preset("e6_trafficsim")),
            "ctg": ("e5", preset("ctg")),
            "ours": ("e7", preset("e7_ours")),
            "ours_guidance": ("e7", preset("ours_guidance_sim")),
        }
        for row, (m, cfgs) in SIM_CFGS.items():
            if m not in methods:
                continue
            mdir = os.path.join(OUT, f"models_{m}")
            if not os.path.exists(os.path.join(mdir, "LAST")):
                continue
            log(f"closed-loop eval: {row}")
            cfgs = cfgs.with_(test=True, **BASE)
            st = _load(cfgs, mdir, dev)
            out = simmod.run_closed_loop_host(
                0, scenes, cfgs, st.net,
                diffusion.get_coeffs(cfgs, device=dev),
                max_steps=SIM_STEPS, record=True)
            step_s = out["history"]["step_s"][1:] or out["history"]["step_s"]
            results[f"closedloop_{row}"] = {
                "compliance": round(float(out["stl_acc"].mean()), 4),
                "area": round(float(out["area"]), 4),
                "progress": round(float(out["progress"].mean()), 3),
                "collision": round(float(out["collide"].mean()), 4),
                "out_of_lane": round(float(out["out_of_lane"].mean()), 4),
                "plan_s_per_step_batch": round(
                    float(np.median(step_s)), 4),
                "scenes": int(len(keep)),
            }
            save_results(results)

    log("results: " + json.dumps(results))


def _load(cfg, mdir, dev):
    """A net built for ``cfg`` on ``dev`` (initialized from ``cfg.seed``)
    with ``mdir``'s weights."""
    net = Net(cfg).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    st = train.init_state(cfg, net, gen)
    return train.load_params_only(mdir, st)


if __name__ == "__main__":
    main()
