"""Closed-loop replanning: ``sim.make_closed_loop_step``'s ``step`` on a
batch of synthetic scenes, one replanning step after another.

Traffic (``traffic`` of the cell's file): ``scenes`` a batch, ``scene_len``
frames a scene, ``episode_steps`` steps an episode, after which the loop
restarts from frame 0 on the next of ``scene_sets`` scene sets (cycling);
``trace_steps`` steps in the traced window.  The sets are one pool of
synthetic scenes drawn from ``scene_pool_seed``, which the run's seed
orders and splits: every seed serves the same scenes, in another order,
since a scene's neighbors and lanes change the work of a step.  Every
step's draws (the sampler's noise) are made here from the seed and the
step's index, and pinned, so that the reference can be handed the same.

The check (``check``): after the window, ``steps`` of the window's steps,
drawn from the seed, are replanned by the reference from the program's
own carry before the step (teacher forcing: the loop's state is the
program's) with the same draws, and compared:

- ``rows_off_share``: the share of the active scenes' candidate rows whose
  final score lies more than ``score_tol`` from the reference's;
- ``scene_median_gap``: in each active scene of each step compared, the
  median over its rows of the gap between the program's score and the
  reference's; the largest.  A fault confined to one scene (its lanes,
  its neighbors, an index off by one) moves most of that scene's rows and
  is a small part of the pooled share; rows that part near a tie of the
  guidance are a minority of any sound scene's;
- ``choice_gap``: the widest gap, over the active scenes, by which the
  program's own lane-keep ranking (its scores less the forward shield's
  penalty, as ``keep_scores`` ranks them) of the row it chose lies below
  its best: the selection stage checked by itself, exact;
- ``env_max_err``: the largest distance between the program's next ego
  state and the reference's env step of the program's own first control
  (recovered from its chosen plan's first two states);
- ``env_flag_mismatches``: scenes whose time, done, collision or
  out-of-lane flag differs from that env step's;
- ``start_mismatches``: scenes of an episode's first step whose start state
  is not the scene's first frame.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import List, NamedTuple

import numpy as np
import torch

from perfbench import traffic
from perfbench.drivers import (UNTRACED_S, check, program, reference,
                               sub_seed)


class Record(NamedTuple):
    """One timed step: its scene set, step in the episode, global index,
    the carry before and after, the plan's chosen states, every row's
    score, every row's least speed and the chosen row of each scene."""
    scene_set: int
    ep_step: int
    k: int
    carry: tuple
    new: tuple
    plan: torch.Tensor
    scores: torch.Tensor
    min_v: torch.Tensor
    choice: torch.Tensor


class Driver:
    def __init__(self, cell, fields, device, seed, impl=None):
        self.traffic = cell.traffic["traffic"]
        self.chk = cell.traffic["check"]
        self.fields = fields
        self.dev = device
        self.seed = int(seed)
        self.impl = impl or program()
        self.weights = cell.config["weights"]["plan"]
        self.attempted = 0
        self.failed = 0
        self.records: List[Record] = []

    # -- set-up ----------------------------------------------------------
    def setup(self):
        P, R = self.impl, reference()
        t = self.traffic
        self.cfg = P.Config(**self.fields)
        rcfg = R.Config(**self.fields)
        from perfbench.reference.port.data import synthetic
        self.bs = int(t["scenes"])
        sets = int(t["scene_sets"])
        pool = traffic.drivable(synthetic.generate_dataset(
            int(t["scene_pool_seed"]), self.bs * sets, rcfg,
            scene_len=int(t["scene_len"])))
        order = np.random.default_rng(sub_seed(self.seed, 1)).permutation(
            self.bs * sets)
        self.data = [{k: v[order[e * self.bs:(e + 1) * self.bs]]
                      for k, v in pool.items()} for e in range(sets)]
        self.noise_shape = ((R.diffusion.n_draws(rcfg),)
                            + tuple(R.diffusion.draw_layout(
                                rcfg, self.bs, 3 * rcfg.n_randoms)))
        net = P.Net(self.cfg)
        P.convert.load_weights(net, self.weights)
        net = net.to(self.dev).eval()
        coeffs = P.diffusion.get_coeffs(self.cfg, self.dev)
        self.sets = []
        for data in self.data:
            scenes = P.sim.scenes_from_dataset(data, device=self.dev)
            self.sets.append(P.sim.make_closed_loop_step(
                scenes, self.cfg, net, coeffs, with_info=True))
        self.episode = 0
        carry, step = self._start(0)
        step(carry, self._noise(0, warm=True))      # the cell's shapes
        self._sync()

    def shapes(self):
        return {"bs": self.bs, "rows": self.bs * 3 * self.cfg.n_randoms}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _start(self, e):
        init, step = self.sets[e % len(self.sets)]
        return init(sub_seed(self.seed, 2, e)), step

    def _noise(self, k, warm=False):
        g = torch.Generator(device=self.dev)
        g.manual_seed(sub_seed(self.seed, 4 if warm else 3, k))
        return torch.randn(self.noise_shape, generator=g, device=self.dev)

    # -- the window --------------------------------------------------------
    def _run(self, until):
        """Steps from a fresh episode until ``until(steps, elapsed)``;
        returns (step seconds, window seconds)."""
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
            self.records.append(Record(
                self.episode % len(self.sets), ep, k, tuple(carry),
                tuple(new), plan, info["scores"],
                torch.amin(info["trajs"][..., 3], dim=-1), choice))
            carry, ep, k = new, ep + 1, k + 1
            if until(len(times), te - t0):
                break
        self.episode += 1
        return times, te - t0

    def window(self, seconds):
        times, window_s = self._run(lambda n, el: el >= seconds)
        self.attempted = len(times)
        ms = np.asarray(times) * 1e3
        thirds = " ".join(f"{np.median(t):.3f}"
                          for t in np.array_split(ms, min(3, len(ms))))
        print(f"window: {len(ms)} steps in {window_s:.3f} s; step ms median "
              f"{np.median(ms):.3f} (by third of the window {thirds}), p95 "
              f"{np.percentile(ms, 95):.3f}, max {ms.max():.3f}",
              file=sys.stderr)
        active = sum(int((~r.carry[2]).sum()) for r in self.records)
        return {"agent_steps_per_s": active / window_s,
                "step_ms_p95": float(np.percentile(ms, 95)),
                "steps": len(times), "window_s": window_s}

    def trace_steps(self):
        n = int(self.traffic["trace_steps"])
        times, _ = self._run(lambda i, el: i >= n)
        self.attempted += len(times)
        return len(times)

    def timed_steps(self):
        """Untimed by the profiler: steps for ``UNTRACED_S`` seconds, and
        ``trace_steps`` at least; their mean seconds (what the mfu readers
        divide by)."""
        n = int(self.traffic["trace_steps"])
        times, window_s = self._run(lambda i, el: i >= n and el >= UNTRACED_S)
        self.attempted += len(times)
        return window_s / len(times)

    def release(self):
        self.sets = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def check(self):
        R = reference()
        c = self.chk
        lim = c["limits"]
        rcfg = R.Config(**self.fields)
        net = R.Net(rcfg)
        R.convert.load_weights(net, self.weights)
        net = net.to(self.dev).eval()
        coeffs = R.diffusion.get_coeffs(rcfg, self.dev)
        if self.dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ref_sets = {}

        def ref_set(s):
            if s not in ref_sets:
                scenes = R.sim.scenes_from_dataset(self.data[s],
                                                   device=self.dev)
                ref_sets[s] = (scenes, R.sim.make_closed_loop_step(
                    scenes, rcfg, net, coeffs, with_info=True)[1])
            return ref_sets[s]

        start_bad = 0
        for r in self.records:
            if r.ep_step == 0:
                ego0 = torch.as_tensor(
                    self.data[r.scene_set]["scene_ego_full"][:, 0, :4],
                    device=self.dev)
                start_bad += int(((r.carry[0] != ego0).any(-1)
                                  | (r.carry[1] != 0) | r.carry[2]).sum())
        live = [i for i, r in enumerate(self.records)
                if bool((~r.carry[2]).any())]
        rng = np.random.default_rng(sub_seed(self.seed, 5))
        picks = sorted(rng.choice(live, size=min(int(c["steps"]), len(live)),
                                  replace=False).tolist()) if live else []
        n_active = off = n_rows = flags = 0
        env_err = gap = scene_gap = 0.0
        failed = 0
        M3 = 3 * rcfg.n_randoms
        for i in picks:
            r = self.records[i]
            scenes, rstep = ref_set(r.scene_set)
            cin = R.sim.Carry(*r.carry[:-1],
                              generator=torch.Generator(device=self.dev))
            _, info = rstep(cin, self._noise(r.k))
            act = ~r.carry[2]
            na = int(act.sum())
            keep = keep_scores(r.scores, r.min_v, rcfg, self.bs)
            g = keep.amax(1) - keep.gather(1, r.choice[:, None])[:, 0]
            gs = float(g[act].max())
            s_p = r.scores.reshape(self.bs, M3)
            s_r = info["scores"].reshape(self.bs, M3)
            gaps = (s_p - s_r).abs()
            of = int(((gaps > c["score_tol"]) & act[:, None]).sum())
            sg = float(gaps[act].median(1).values.max())
            ego, t, done, col, ool = r.carry[:5]
            th, v = r.plan[:, :, 2], r.plan[:, :, 3]
            u0 = torch.stack([(th[:, 1] - th[:, 0]) / rcfg.dt,
                              (v[:, 1] - v[:, 0]) / rcfg.dt], dim=-1)
            e_state, e_col, e_ool, e_done = R.sim.env_step(scenes, ego, t, u0,
                                                           rcfg)
            new = r.new
            err = float(((new[0] - e_state).abs().amax(-1) * act).max())
            want = (torch.where(act, t + 1, t),
                    done | ((e_col | e_ool | e_done) & act),
                    col | (e_col & act), ool | (e_ool & act))
            fl = int(sum(((a != b) & act).sum()
                         for a, b in zip(want, new[1:5])))
            n_active, off = n_active + na, off + of
            n_rows, flags = n_rows + na * M3, flags + fl
            env_err, gap = max(env_err, err), max(gap, gs)
            scene_gap = max(scene_gap, sg)
            if (gs > lim["choice_gap"] or of > lim["rows_off_share"] * na * M3
                    or sg > lim["scene_median_gap"]
                    or err > lim["env_max_err"]
                    or fl > lim["env_flag_mismatches"]):
                failed += 1
        self.failed = failed + (1 if start_bad else 0)
        return [check("choice_gap", gap, lim["choice_gap"]),
                # no row compared reads as all rows off
                check("rows_off_share", off / n_rows if n_rows else 1.0,
                      lim["rows_off_share"]),
                check("scene_median_gap",
                      scene_gap if n_rows else float("inf"),
                      lim["scene_median_gap"]),
                check("env_max_err", env_err, lim["env_max_err"]),
                check("env_flag_mismatches", flags,
                      lim["env_flag_mismatches"]),
                check("start_mismatches", start_bad,
                      lim["start_mismatches"])]


def keep_scores(scores, min_v, cfg, bs):
    """The planner's lane-keep ranking of every row (bs, M * 3), as
    ``sim.make_planner`` ranks them: the score less the forward shield's
    penalty (from each row's least speed) on the keep rows, -10000 on the
    others."""
    M = cfg.n_randoms
    s = scores.reshape(bs, M, 3)
    if cfg.forward_shield:
        s = s - torch.clamp(-min_v.reshape(bs, M, 3), min=0.0) * 1e3
    keep = torch.arange(3, device=s.device)[None, None, :] == 0
    return torch.where(keep, s, torch.full_like(s, -10000.0)).reshape(bs, -1)
