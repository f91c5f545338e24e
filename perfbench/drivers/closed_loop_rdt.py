"""Closed-loop replanning with RDT-1B's diffusion transformer as the
planner's eps network: ``closed_loop_unet1d``'s traffic (finished scenes
restart from their first frame), window, probe and checks, on a net built
from the configuration's ``eps_net`` block.

No trained weights are in the repository: the program's net
(``Net(cfg, eps_net=RdtSpec(...))``, ``models.net.init_seeded``) and the
reference's (the frozen ``Net`` with ``reference/rdt.attach``) are drawn
from ``eps_net.weights_seed`` on a CPU generator, each by its own code, in
the same order.  The program's net is built on the meta device and drawn
once (PyTorch's own initialization of 1.2 B parameters would be drawn and
thrown away).  The reference planner is the frozen one with the plain
RDT in float32 as its eps function (``reference/rdt.install``).

The checks are ``closed_loop_unet1d``'s, with ``eps_rms_err`` in place of
its ``eps_rel_err``: the replayed chain's eps at t = 99, 50 and 1 against
the reference's eps function of the same step on the same states, at
every row, as the root mean square of the difference (the largest of
the three).  That is in the unit of the noise eps estimates, which is
the scale the chain adds it at.  The seeded RDT's own eps has an rms of
0.28 to 1.14 by the scene's state, while the bfloat16 difference stays
near 0.01: divided by eps's norm, the error would read 4x higher in
some states than in others.

``shapes()`` adds the RDT's passes a step and rows a pass, counted
(``models/rdt.calls`` / ``rows``) over the untraced steps before the
trace, and its widths, for ``metrics/rdt_mfu.plan.py``.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

from perfbench.drivers import check, closed_loop, program
from perfbench.drivers import closed_loop_unet1d as with_restarts
from perfbench.reference import rdt as ref_rdt
from pstl_tpu_torch.models import net as program_net
from pstl_tpu_torch.models import rdt as program_rdt

#: the spec's keys in the configuration's ``eps_net`` block
WIDTHS = ("hidden_size", "depth", "num_heads", "state_token_dim", "lang_in",
          "img_in", "out_dim", "freq_hz")


def with_rdt(impl, spec: dict, seed: int, dt=None, nets=None):
    """``impl`` (the program, or the reference or the control in its
    place) building its plan net with the RDT ``spec``, drawn from
    ``seed``; the reference's RDT in ``dt`` where given, and each net it
    loads appended to ``nets`` where given."""
    if impl.name == "program":
        def make(cfg):
            with torch.device("meta"):
                return impl.Net(cfg, eps_net=program_rdt.RdtSpec(**spec))

        def load(net, _):
            net.to_empty(device="cpu")
            program_net.init_seeded(net, torch.Generator().manual_seed(seed))
    else:
        ref_rdt.install()
        make = impl.Net

        def load(net, _):
            ref_rdt.attach(net, spec, seed, dt)
            if nets is not None:
                nets.append(net)
    return SimpleNamespace(**dict(vars(impl), Net=make,
                                  convert=SimpleNamespace(load_weights=load)))


class Driver(with_restarts.Driver):
    def __init__(self, cell, fields, device, seed, impl=None):
        eps = cell.config["eps_net"]
        self.spec = {k: eps[k] for k in WIDTHS}
        self.weights_seed = int(eps["weights_seed"])
        closed_loop.Driver.__init__(
            self, cell, fields, device, seed,
            impl=with_rdt(impl or program(), self.spec, self.weights_seed))
        self.restarted = {}
        self.eps_counts = None
        self.probe = None

    def timed_steps(self):
        c0, r0 = program_rdt.calls, program_rdt.rows
        n0 = len(self.records)
        out = closed_loop.Driver.timed_steps(self)
        calls = program_rdt.calls - c0
        self.eps_counts = (calls / (len(self.records) - n0),
                           (program_rdt.rows - r0) / calls if calls else 0)
        return out

    def check(self):
        nets = []
        with _reference_with_rdt(self.spec, self.weights_seed, nets):
            out = closed_loop.Driver.check(self)
        made = nets[-1].rdt.made if nets else []
        picks = self.picks()
        ref_fn = made[0] if picks and len(made) == len(picks) else None
        bad = self._restart_mismatches()
        if bad and not any(c["name"] == "start_mismatches" and c["value"]
                           for c in out):
            self.failed += 1
        out = [check(c["name"], c["value"] + bad, c["limit"])
               if c["name"] == "start_mismatches" else c for c in out]
        return out + [check("eps_rms_err", self._eps_rms_err(ref_fn),
                            self.chk["limits"]["eps_rms_err"])]

    def _eps_rms_err(self, ref_fn) -> float:
        """The program's taps against ``ref_fn`` (the reference's eps
        function of the same step) on the tapped states: the largest over
        the tapped steps of the rms of eps - eps_ref over every row."""
        p = self.probe
        if p is None or ref_fn is None or not p["same"]:
            return float("inf")
        with torch.no_grad():
            return max(eps_rms(e, ref_fn(x.float(), t))
                       for t, (x, e) in p["taps"].items())


def eps_rms(e, e_ref) -> float:
    """The root mean square of ``e - e_ref``."""
    return float((e.float() - e_ref).pow(2).mean().sqrt())


@contextlib.contextmanager
def _reference_with_rdt(spec, seed, nets):
    """``closed_loop``'s check replanning on the reference with the RDT in
    float32 (it builds its reference from ``closed_loop.reference``); the
    nets it loads appended to ``nets``."""
    real = closed_loop.reference
    closed_loop.reference = lambda: with_rdt(real(), spec, seed,
                                             torch.float32, nets)
    try:
        yield
    finally:
        closed_loop.reference = real
