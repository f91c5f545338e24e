"""Closed-loop replanning with Diffusion Policy's ConditionalUnet1D as the
planner's eps network: ``closed_loop``'s traffic, window and checks on a
net built from the configuration's ``eps_net`` block.

No trained weights exist: the program's net (``Net(cfg, eps_net=spec)``,
``models.net.init_seeded``) and the reference's (the frozen ``Net`` with
``reference/unet1d.attach``) are drawn from ``eps_net.weights_seed`` on a
CPU generator, each by its own code, in the same order.  The reference
planner is the frozen one with the plain U-Net in float32 as its eps
function (``reference/unet1d.install``).

Traffic, beyond ``closed_loop``'s: a scene that finishes (leaves the
lane, collides or runs out of frames) starts again from its first frame
on the next step, as an evaluator that refills a finished slot of its
batch does, so that every step plans for as many live scenes as the
batch holds (under seeded weights most scenes leave the lane within a
few steps).  ``start_mismatches`` counts such restarts whose state is not
the scene's first frame too.

One check more than ``closed_loop``'s:

- ``eps_rel_err``: the first step the check compares is planned again by
  the program, twice from the same carry and draws (the first plan
  captures the chain's graph with copies of the eps network's input and
  output at t = 99, 50 and 1 (:func:`eps_steps`) in it, the second
  replays it), and the copies are compared with the reference's eps
  function of that step's replan (its own encoders, on its own batch) on
  the same states: the largest over the three of ||eps - eps_ref||_2 /
  ||eps_ref||_2 over every row.  A replay whose scores are not the
  timed step's, to the bit, reads as infinite: it is not the plan the
  window made.

``shapes()`` adds the U-Net's passes a step and rows a pass, counted
(``models/unet1d.calls`` / ``rows``) over the untraced steps before the
trace, and its widths, for ``metrics/eps_mfu.plan.py``.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.drivers import check, closed_loop, program, sub_seed
from perfbench.reference import unet1d as ref_unet
from pstl_tpu_torch.models import net as program_net
from pstl_tpu_torch.models import unet1d as program_unet


def eps_steps(T: int):
    """The timesteps ``eps_rel_err`` compares at: the first denoise step,
    the middle one and the last (99, 50, 1 of T = 100)."""
    return (T - 1, T // 2, 1)


#: the spec's keys in the configuration's ``eps_net`` block
WIDTHS = ("down_dims", "kernel_size", "n_groups", "step_embed_dim",
          "cond_predict_scale")


def with_unet(impl, spec: dict, seed: int, dt=None, nets=None):
    """``impl`` (the program, or the reference or the control in its
    place) building its plan net with the U-Net ``spec``, drawn from
    ``seed``; the reference's U-Net in ``dt`` where given, and each net it
    loads appended to ``nets`` where given."""
    if impl.name == "program":
        def make(cfg):
            return impl.Net(cfg, eps_net=program_unet.UnetSpec(**spec))

        def load(net, _):
            program_net.init_seeded(net, torch.Generator().manual_seed(seed))
    else:
        ref_unet.install()
        make = impl.Net

        def load(net, _):
            ref_unet.attach(net, spec, seed, dt)
            if nets is not None:
                nets.append(net)
    return SimpleNamespace(**dict(vars(impl), Net=make,
                                  convert=SimpleNamespace(load_weights=load)))


class _TapKey:
    """The weights key of a tapped eps function: the chain's graph cache
    (``diffusion._GRAPHS``) captures a graph of its own for it."""


def tapped(fn, ts, taps: dict, key):
    """``fn`` (an ``eps_cm(x_cm, t)``), keeping its input and output at
    each timestep of ``ts`` in ``taps[t]``: cloned on the first pass, then
    copied into those tensors, so that a captured chain's replay writes
    them.  Keeps ``fn``'s ``inputs``, ``counters`` and ``on_base`` (tapped
    alike), with ``key`` as its ``weights``."""
    def eps_cm(x, t):
        e = fn(x, t)
        if t in ts:
            if t in taps:
                taps[t][0].copy_(x)
                taps[t][1].copy_(e)
            else:
                taps[t] = (x.clone(), e.clone())
        return e

    for name in ("inputs", "counters"):
        if hasattr(fn, name):
            setattr(eps_cm, name, getattr(fn, name))
    if hasattr(fn, "on_base"):
        eps_cm.on_base = lambda d: tapped(fn.on_base(d), ts, taps, key)
    eps_cm.weights = key
    return eps_cm


class Driver(closed_loop.Driver):
    def __init__(self, cell, fields, device, seed, impl=None):
        eps = cell.config["eps_net"]
        self.spec = {k: eps[k] for k in WIDTHS}
        self.weights_seed = int(eps["weights_seed"])
        super().__init__(cell, fields, device, seed,
                         impl=with_unet(impl or program(), self.spec,
                                        self.weights_seed))
        #: global step index -> the scenes restarted in its carry
        self.restarted = {}
        self.eps_counts = None
        self.probe = None

    def setup(self):
        super().setup()
        self.fresh = [init(0) for init, _ in self.sets]

    # -- the window: finished scenes restart -------------------------------
    def _restart(self, carry, e: int, k: int):
        """``carry`` with each finished scene at its first frame again (the
        scene set ``e``'s start); the scenes are kept for step ``k``'s
        check."""
        done = carry.done
        if not bool(done.any()):
            return carry
        self.restarted[k] = done.clone()
        fresh = self.fresh[e % len(self.sets)]
        return carry._replace(**{
            f: torch.where(done.reshape((-1,) + (1,) * (v.dim() - 1)),
                           getattr(fresh, f), v)
            for f, v in carry._asdict().items() if torch.is_tensor(v)})

    def _run(self, until):
        """``closed_loop.Driver._run`` with :meth:`_restart` between steps
        (outside each step's timing, inside the window's)."""
        ep_len = int(self.traffic["episode_steps"])
        carry, step = self._start(self.episode)
        ep, k, times = 0, len(self.records), []
        t0 = time.perf_counter()
        while True:
            if ep == ep_len:
                self.episode += 1
                carry, step = self._start(self.episode)
                ep = 0
            noise = self._noise(k)
            ts = time.perf_counter()
            new, info = step(carry, noise)
            self._sync()
            te = time.perf_counter()
            times.append(te - ts)
            plan = info["plan_traj"]
            trajs = info["trajs"].reshape(self.bs, -1, *plan.shape[1:])
            choice = (trajs - plan[:, None]).abs().amax(dim=(2, 3)).argmin(1)
            self.records.append(closed_loop.Record(
                self.episode % len(self.sets), ep, k, tuple(carry),
                tuple(new), plan, info["scores"],
                torch.amin(info["trajs"][..., 3], dim=-1), choice))
            if until(len(times), te - t0):
                break
            carry, ep, k = new, ep + 1, k + 1
            if ep < ep_len:
                carry = self._restart(carry, self.episode, k)
        self.episode += 1
        return times, te - t0

    def timed_steps(self):
        c0, r0 = program_unet.calls, program_unet.rows
        n0 = len(self.records)
        out = super().timed_steps()
        calls = program_unet.calls - c0
        self.eps_counts = (calls / (len(self.records) - n0),
                           (program_unet.rows - r0) / calls if calls else 0)
        return out

    def shapes(self):
        out = super().shapes()
        if self.eps_counts and self.eps_counts[0]:
            out.update(eps_calls=self.eps_counts[0],
                       eps_rows=self.eps_counts[1], eps_net=self.spec,
                       nt=self.cfg.nt)
        return out

    # -- eps_rel_err -------------------------------------------------------
    def picks(self):
        """The records ``closed_loop.Driver.check`` compares, in its order
        (its draw, repeated)."""
        live = [i for i, r in enumerate(self.records)
                if bool((~r.carry[2]).any())]
        if not live:
            return []
        rng = np.random.default_rng(sub_seed(self.seed, 5))
        return sorted(rng.choice(live, size=min(int(self.chk["steps"]),
                                                len(live)),
                                 replace=False).tolist())

    def _probe(self):
        """Plan the first checked step again, twice, with the program's own
        step and its eps function tapped at :func:`eps_steps`: the taps of
        the second plan (the graph's replay, on the card) and whether its
        scores are the timed step's."""
        picks = self.picks()
        if not picks:
            return None
        r = self.records[picks[0]]
        P = self.impl
        _, step = self.sets[r.scene_set]
        models = P.sim.models
        real = models.make_cm_eps_fn
        ts = eps_steps(int(self.cfg.diffusion_steps))
        taps, key = {}, _TapKey()

        def spy(*a, **kw):
            return tapped(real(*a, **kw), ts, taps, key)

        noise = self._noise(r.k)
        models.make_cm_eps_fn = spy
        try:
            for _ in range(2):
                carry = P.sim.Carry(
                    *r.carry[:-1], generator=torch.Generator(device=self.dev))
                _, info = step(carry, noise)
        finally:
            models.make_cm_eps_fn = real
        self._sync()
        same = torch.equal(info["scores"], r.scores)
        return {"taps": {t: taps[t] for t in ts}, "same": same}

    def release(self):
        self.probe = self._probe()
        self.fresh = None
        super().release()

    def _eps_rel_err(self, ref_fn) -> float:
        """The program's taps against ``ref_fn`` (the reference's eps
        function of the same step) on the tapped states."""
        p = self.probe
        if p is None or ref_fn is None or not p["same"]:
            return float("inf")
        worst = 0.0
        with torch.no_grad():
            for t, (x, e) in p["taps"].items():
                e_ref = ref_fn(x.float(), t)
                worst = max(worst, float((e.float() - e_ref).norm()
                                         / e_ref.norm()))
        return worst

    def _restart_mismatches(self) -> int:
        """Restarted scenes whose state is not their scene's first frame."""
        bad = 0
        for r in self.records:
            mask = self.restarted.get(r.k)
            if mask is None:
                continue
            ego0 = torch.as_tensor(
                self.data[r.scene_set]["scene_ego_full"][:, 0, :4],
                device=self.dev)
            bad += int((((r.carry[0] != ego0).any(-1) | (r.carry[1] != 0)
                         | r.carry[2]) & mask).sum())
        return bad

    def check(self):
        nets = []
        with _reference_with_unet(self.spec, self.weights_seed, nets):
            out = super().check()
        made = nets[-1].unet.made if nets else []
        picks = self.picks()
        ref_fn = made[0] if picks and len(made) == len(picks) else None
        lim = self.chk["limits"]
        bad = self._restart_mismatches()
        if bad and not any(c["name"] == "start_mismatches" and c["value"]
                           for c in out):
            self.failed += 1
        out = [check(c["name"], c["value"] + bad, c["limit"])
               if c["name"] == "start_mismatches" else c for c in out]
        return out + [check("eps_rel_err", self._eps_rel_err(ref_fn),
                            lim["eps_rel_err"])]


@contextlib.contextmanager
def _reference_with_unet(spec, seed, nets):
    """``closed_loop``'s check replanning on the reference with the U-Net
    in float32 (it builds its reference from ``closed_loop.reference``);
    the nets it loads appended to ``nets``."""
    real = closed_loop.reference
    closed_loop.reference = lambda: with_unet(real(), spec, seed,
                                              torch.float32, nets)
    try:
        yield
    finally:
        closed_loop.reference = real
