"""Ranks of the parallel-layer tests (``tests/test_torch_parallel*.py``).

:func:`run_ranks` starts ``world`` processes of this file, each a rank of a
gloo group over a ``file://`` store in the run's directory, one thread
each.  Every rank reads the cases the test wrote (``inputs.pt``: a list of
(kind, arguments)), runs each with ``pstl_tpu_torch.parallel`` and writes
what it computed to ``out<rank>.pt``.  The tests compare the ranks' results
with one another, with the port's one-process run and with the JAX
package's.  The file imports neither jax nor the JAX package.

    python tests/torch_parallel_case.py <rank> <world> <run directory>
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
#: seconds a run of the ranks may take
TIMEOUT_S = 600


def run_ranks(cases, tmp_dir, world=2, timeout=TIMEOUT_S):
    """Run ``cases`` (a list of (kind, kwargs)) on ``world`` ranks; returns
    every rank's list of results and the run's wall seconds."""
    tmp_dir = str(tmp_dir)
    torch.save(cases, os.path.join(tmp_dir, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, HERE, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         tmp_dir], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, (r, out[-2000:], err[-4000:])
    return ([torch.load(os.path.join(tmp_dir, f"out{r}.pt"),
                        weights_only=False) for r in range(world)],
            time.time() - t0)


# ---------------------------------------------------------------------------
# the cases (run on every rank)
# ---------------------------------------------------------------------------

def _mesh(world, name):
    from pstl_tpu_torch.parallel import make_mesh
    return make_mesh((world,), (name,), device_type="cpu")


def case_basics(world):
    """test_parallel.py's mesh cases on this rank: the inferred size, the
    batch split and replication, the replicated-parameter mean, the row
    range and the global batch, and the two-process global mean."""
    from pstl_tpu_torch import parallel
    from pstl_tpu_torch.parallel import mesh as pmesh
    mesh = parallel.make_mesh((-1,), ("data",), device_type="cpu")
    out = {"size": mesh.size(0)}
    batch = {"a": np.arange(64, dtype=np.float32).reshape(16, 4),
             "b": np.ones((3,), np.float32)}
    sb = parallel.shard_batch(batch, mesh)
    out["a"], out["b"] = sb["a"], sb["b"]
    x = torch.ones((16, 8))
    w = torch.ones((8, 4))
    xl = parallel.shard_batch({"x": x}, mesh)["x"]
    out["replicated_mean"] = float(parallel.psum_metrics(
        {"m": torch.mean(xl @ w)}, mesh)["m"])
    full = np.arange(64, dtype=np.float32).reshape(16, 4)
    rows = parallel.local_rows(16)
    out["rows"] = (rows.start, rows.stop)
    gb = parallel.global_batch_from_local({"x": full[rows]}, mesh)
    out["global_mean"] = float(parallel.psum_metrics(
        {"m": torch.mean(gb["x"])}, mesh)["m"])
    rank = torch.distributed.get_rank()
    try:
        parallel.global_batch_from_local(
            {"x": full[:4 + 4 * rank]}, mesh)
        out["unequal"] = "accepted"
    except ValueError as e:
        out["unequal"] = str(e)
    # whole draws sliced: a rank's rows of a draw are the whole draw's
    g = torch.Generator().manual_seed(3)
    with parallel.data_sharding(mesh):
        out["draw"] = pmesh.draw(lambda s: torch.randn(s, generator=g),
                                 (8 // world, 5))
        out["mask_mean"] = float(pmesh.shard_mean(torch.mean(
            torch.arange(8 // world, dtype=torch.float32) + 10 * rank)))
    return out


def case_train_step(world, cfg, state, batch, draws):
    """One train step of the port under a data mesh: the whole batch and
    draws on every rank.  Returns the metrics, the averaged gradients and
    the parameters after the step."""
    from pstl_tpu_torch import diffusion, specs, train
    from pstl_tpu_torch.config import Config
    from pstl_tpu_torch.models.net import Net
    cfg = Config(**cfg)
    net = Net(cfg)
    net.load_state_dict(state)
    mesh = _mesh(world, "data")
    step = train.make_train_step(cfg, net, specs.build_scorer(cfg),
                                 diffusion.get_coeffs(cfg),
                                 train.make_optimizer(cfg, net), mesh=mesh)
    rd = step(train.to_device(batch, "cpu"), draws=draws)
    return {"metrics": {k: float(v) for k, v in rd.items()},
            "grads": {k: (torch.zeros_like(p) if p.grad is None
                          else p.grad.clone())
                      for k, p in net.named_parameters()},
            "state": {k: v.clone() for k, v in net.state_dict().items()}}


def case_train_loop(world, cfg, scenes, epochs):
    """``train.train`` under a data mesh over a synthetic dataset: every
    batch's global metrics and the final parameters."""
    from pstl_tpu_torch import train
    from pstl_tpu_torch.config import Config
    from pstl_tpu_torch.data.dataset import SceneDataset
    cfg = Config(**cfg)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=scenes)
    hist = []
    state = train.train(cfg, ds, epochs=epochs, device="cpu", history=hist,
                        log=lambda *_: None, mesh=_mesh(world, "data"))
    return {"history": hist, "state": {k: v.clone() for k, v in
                                       state.net.state_dict().items()}}


def closed_loop(cfg, data, state, noise, chunk=1, seed=1, mesh=None,
                cand_mesh=None):
    """Closed-loop steps of the port: ``len(noise)`` steps with the pinned
    draws (whole-batch tensors), ``chunk`` a call; scene-sharded over
    ``mesh``'s "data" axis or candidate-sharded over ``cand_mesh``'s
    "cand" axis.  Returns the per-scene metrics (every scene's) and the ego
    states."""
    import contextlib
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.config import Config
    from pstl_tpu_torch.models.net import Net
    from pstl_tpu_torch.parallel import candidate_sharding
    from pstl_tpu_torch.parallel.mesh import gather_rows
    cfg = Config(**cfg)
    net = Net(cfg)
    net.load_state_dict(state)
    net.eval()
    scenes = sim.scenes_from_dataset(data, device="cpu")
    if mesh is not None:
        scenes = sim.shard_scenes(scenes, mesh)
    init, step = sim.make_closed_loop_step(scenes, cfg, net,
                                           diffusion.get_coeffs(cfg),
                                           chunk=chunk, mesh=mesh)
    ctx = (candidate_sharding(cand_mesh, "cand") if cand_mesh is not None
           else contextlib.nullcontext())
    c = init(seed)
    with ctx:
        for i in range(0, len(noise), chunk):
            c = step(c, noise[i] if chunk == 1 else noise[i:i + chunk])
    m = sim._carry_metrics(c, mesh)
    ego = c.ego if mesh is None else gather_rows(c.ego, mesh)
    return {"metrics": {k: v.clone() for k, v in m.items()}, "ego": ego}


def case_scene_loop(world, chunk, **kw):
    return closed_loop(mesh=_mesh(world, "data"), chunk=chunk, **kw)


def case_cand_loop(world, **kw):
    return closed_loop(cand_mesh=_mesh(world, "cand"), **kw)


def case_cand_plan(world, cfg, data, seed=0):
    """One plan of the port on the first scenes at t = 0 with seeded weights
    and whole pinned draws: unsharded and candidate-sharded on this rank,
    the kernels' plain versions counted."""
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.config import Config
    from pstl_tpu_torch.models.net import Net, init_flax_like
    from pstl_tpu_torch.ops import guidance_kernel, superstep_kernel
    from pstl_tpu_torch.parallel import candidate_sharding
    cfg = Config(**cfg)
    net = Net(cfg)
    init_flax_like(net, torch.Generator().manual_seed(seed))
    net.eval()
    scenes = sim.scenes_from_dataset(data, device="cpu")
    bs = scenes.ego_full.shape[0]
    obs = sim.observe(scenes, scenes.ego_full[:, 0],
                      torch.zeros(bs, dtype=torch.long), cfg)
    R = 3 * cfg.n_randoms
    g = torch.Generator().manual_seed(seed + 1)
    noise = torch.randn((diffusion.n_draws(cfg),
                         *diffusion.draw_layout(cfg, bs, R)), generator=g)
    plan = sim.make_planner(cfg, net, diffusion.get_coeffs(cfg))
    calls = {}
    wrappers = {"fused": (guidance_kernel, "guidance_fused"),
                "frozen": (guidance_kernel, "guidance_frozen"),
                "superstep": (superstep_kernel, "superstep")}
    saved = {k: getattr(m, n) for k, (m, n) in wrappers.items()}
    for key, (mod, name) in wrappers.items():
        def counted(*a, _real=saved[key], _key=key, **k):
            calls[_key] = calls.get(_key, 0) + 1
            return _real(*a, **k)
        setattr(mod, name, counted)
    try:
        u_one, info_one = plan(obs, noise=noise)
        one_calls = dict(calls)
        calls.clear()
        with candidate_sharding(_mesh(world, "cand"), "cand"):
            u, info = plan(obs, noise=noise)
    finally:
        for key, (mod, name) in wrappers.items():
            setattr(mod, name, saved[key])
    keys = ("controls", "scores", "trajs", "plan_traj", "stl_acc")
    return {"u_one": u_one, "u": u,
            "one": {k: info_one[k] for k in keys},
            "sharded": {k: info[k] for k in keys},
            "calls_one": one_calls, "calls": dict(calls)}


def case_cand_refuses(world, cfg, data):
    """Candidate sharding with n_randoms not divisible by the axis."""
    try:
        case_cand_plan(world, cfg, data)
    except ValueError as e:
        return str(e)
    return "accepted"


def main(rank, world, run_dir):
    torch.set_num_threads(1)
    from pstl_tpu_torch.parallel import init_multihost
    init_multihost(init_method="file://" + os.path.join(run_dir, "store"),
                   world_size=world, rank=rank, device="cpu",
                   timeout_s=300)
    cases = torch.load(os.path.join(run_dir, "inputs.pt"),
                       weights_only=False)
    out = [globals()["case_" + kind](world, **kw) for kind, kw in cases]
    torch.save(out, os.path.join(run_dir, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
