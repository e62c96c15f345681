"""The step loops as device programs: CUDA graphs over BDF steps and
Newton iterations.

The JAX package runs its step loops as one XLA program each: a
``jax.lax.scan`` over the horizon (models/solver.py:421 there) with the
Newton iterations as ``jax.lax.while_loop`` (models/newton.py:291,
models/trpl.py:254).  The port's loops (models/solver.solve, the coarse
and off-grid phases of models/twophase.py and models/offgrid.py, and the
plain chains of ops/horizon_kernel.py) are Python over PyTorch
operations.  On the card each step and each iteration is a few dozen to a
few hundred small kernels, so the host's dispatch, and a loop exit test
that waits for the device, bound them.  This module runs them as captured
device work instead.

Three routes, one per loop (:func:`route_for`):

* ``"eager"`` -- the loops as written: each Newton loop tests its exit
  on the host before every iteration.  The plain version, and the CPU's
  route.
* ``"masked"`` -- the restructured schedule without graphs: the caller's
  step body keeps its state in buffers it updates in place, and a Newton
  loop's exit test lags one iteration (:meth:`StepRunner.loop`): iteration
  i + 1 is issued before iteration i's "all done" flag is read, so the
  device never waits for the host.  An iteration after every sample is
  done changes nothing, so the results are bitwise the eager route's.
  (The plain chord chain, whose iterations branch on whether a Jacobian
  refresh is asked for, reads that and its exit before each iteration
  instead.)  Runs on any device.
* ``"graph"`` -- the masked schedule with every piece (a step's set-up, an
  iteration, a step's end; a whole step where the Newton loop is one
  kernel launch) captured once as a CUDA graph and replayed.  The route
  of CUDA tensors.

A caller asks for a route with :func:`route`; without one, CUDA tensors
take ``"graph"`` and CPU tensors ``"eager"``.  A failed capture or replay
raises: nothing falls back to another route.  ``replays`` counts the
graph replays of the process, as the kernel wrappers count launches.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Hashable

import torch

ROUTES = ("eager", "masked", "graph")

# Graph replays of this process: "step" counts the step-level graphs (a
# step's set-up and end, or a whole step), "iteration" the Newton or
# Gauss-Seidel iterations; chip_smoke.py zeroes them around each main path.
replays = {"step": 0, "iteration": 0}

_route = contextvars.ContextVar("trpl_step_route", default=None)
# The replay hooks of the graph being captured (see on_replay).
_capture_hooks = contextvars.ContextVar("trpl_capture_hooks", default=None)


@contextlib.contextmanager
def route(name: str):
    """Run the step loops started in the block on route ``name``."""
    if name not in ROUTES:
        raise ValueError(f"step loop route {name!r}: not one of {ROUTES}")
    token = _route.set(name)
    try:
        yield
    finally:
        _route.reset(token)


def route_for(device) -> str:
    """The route of a step loop on ``device``: the one asked for with
    :func:`route`, else ``"graph"`` on CUDA and ``"eager"`` elsewhere."""
    device = torch.device(device)
    name = _route.get()
    if name is None:
        return "graph" if device.type == "cuda" else "eager"
    if name == "graph" and device.type != "cuda":
        raise ValueError(f"step loops: the graph route needs CUDA tensors, got "
                         f"{device}")
    return name


def on_replay(hook: Callable[[], None]) -> None:
    """For a kernel wrapper that launches while a step graph is captured:
    ``hook`` runs at every replay of that graph (the wrapper's launch
    count; the capture itself launches nothing)."""
    hooks = _capture_hooks.get()
    if hooks is None:
        raise RuntimeError("a kernel launch was captured outside a step graph: "
                           "its launches could not be counted")
    hooks.append(hook)


def eager_loop(loop) -> int:
    """Run a Newton loop (see :meth:`StepRunner.loop`) with its exit
    tested on the host before each iteration: the eager route, and the
    loop of models/newton.coupled_newton_step and models/trpl.implicit_step.
    Returns the iterations run."""
    i = 0
    while i < loop.limit and not bool(loop.all_done()):
        loop.iterate(loop.variant(i), False)
        i += 1
    return i


class StepRunner:
    """Runs the pieces of one step loop on its route (see the module
    docstring).  A piece is a function with no host wait that updates
    buffers allocated before it runs; on the graph route it is captured
    once per ``key`` (the key must name every Python branch the piece
    takes) and replayed after, in one memory pool per runner."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.route = route_for(self.device)
        self.graphs = {}
        self.on_cuda = self.device.type == "cuda"
        # The loop's exit flag: written on the device by each iteration,
        # read by the host one iteration later.
        self.flag = torch.zeros((), dtype=torch.bool, device=self.device)
        if self.on_cuda and self.route != "eager":
            self.host = torch.zeros(2, dtype=torch.bool, pin_memory=True)
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
            self.slot = 0
        if self.route == "graph":
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    @property
    def launch_stream(self):
        """The stream a kernel launched inside a piece must be bound to."""
        return self.stream if self.route == "graph" else torch.cuda.current_stream(self.device)

    def run(self, key: Hashable, fn: Callable[[], None], kind: str = "step"):
        """Run ``fn`` once: directly, or on the graph route as the replay of
        its graph (captured at the key's first call)."""
        if self.route != "graph":
            fn()
            return
        with torch.cuda.device(self.device):
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(fn)
            entry[0].replay()
        replays[kind] += 1
        for hook in entry[1]:
            hook()

    def _capture(self, fn):
        graph, hooks = torch.cuda.CUDAGraph(), []
        token = _capture_hooks.set(hooks)
        try:
            with torch.cuda.stream(self.stream):
                # "relaxed": the driver may load a kernel's module at its
                # first launch, inside the capture; a wait on the capturing
                # stream (a host read of a device value) still fails it.
                graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            _capture_hooks.reset(token)
        return graph, hooks

    def loop(self, key: Hashable, loop) -> int:
        """Run a Newton loop: ``loop.iterate(v, masked)`` in place for
        iterations i = 0, 1, ... (``v = loop.variant(i)``, every Python
        branch of the iteration) while i < ``loop.limit`` and not
        ``loop.all_done()``.  Returns the iterations run.

        Eager route: the exit test before each iteration, on the host.
        A loop whose iterations branch on its device state
        (``loop.synced``, the chord chain's Jacobian refresh) reads that
        state before each iteration: ``loop.variant(i)`` returns None once
        every sample is done, and the iteration runs as its variant's
        graph.  Otherwise the test lags: the caller's set-up leaves the
        initial flag in ``self.flag`` (:meth:`mark`), each iteration writes
        its own, and iteration i + 1 is issued before iteration i's flag is
        read.  So at most one iteration more runs than on the eager route,
        and never more than ``loop.limit``; it must change nothing."""
        if self.route == "eager":
            return eager_loop(loop)
        if getattr(loop, "synced", False):
            for i in range(loop.limit):
                v = loop.variant(i)
                if v is None:
                    return i
                self.run((key, v), lambda v=v: loop.iterate(v, True), "iteration")
            return loop.limit
        pending = [self._send()]
        for i in range(loop.limit):
            v = loop.variant(i)
            self.run((key, v), lambda v=v: (loop.iterate(v, True), self.mark(loop)),
                     "iteration")
            pending.append(self._send())
            if self._receive(pending.pop(0)):
                return i + 1
        return loop.limit

    def mark(self, loop):
        """Write ``loop.all_done()`` into the flag (inside a piece)."""
        self.flag.copy_(loop.all_done())

    def _send(self):
        if not self.on_cuda:
            return bool(self.flag)
        slot = self.slot
        self.slot ^= 1
        self.host[slot].copy_(self.flag, non_blocking=True)
        self.events[slot].record(torch.cuda.current_stream(self.device))
        return slot

    def _receive(self, sent) -> bool:
        if not self.on_cuda:
            return sent
        self.events[sent].synchronize()
        return bool(self.host[sent])


def step_class(t: int) -> int:
    """The key of BDF step t's coefficients and history slots: t during
    the startup ramp (t < 4), then 4 + t % 6 (models/trpl.BDF_TABLE's BDF5
    row over the 6 rolling slots)."""
    return t if t < 4 else 4 + t % 6
