"""Deterministic fault injection for the serving stack and the training
loop.

The PyTorch port's copy of ``paddle_tpu/testing/faults.py``
(``FaultInjector``, ``seeded_plan`` and ``TrainFaultInjector``).

The resilience contract — "the engine degrades instead of crashing" —
is only worth committing if CI can PROVE it, and proving it needs
faults that are (a) the real failure modes and (b) exactly
reproducible. This module provides the injection points the chaos gate
(``tools/torch_serve_gates.py``) and the port's tests drive:

* **alloc failure** — wrap ``engine.allocator.alloc`` and raise the
  allocator's own ``RuntimeError`` at scheduled call indices (one
  transient failure: preemption rescues it) or for whole scheduled
  steps (nothing helps: the requester must fail per-request). The
  schedule is indexed from ``attach()``, so replaying the same plan on
  a warmed engine reproduces the same fault sequence.
* **slow/stalled steps** — route through the inference layer's
  ``set_dispatch_delay`` hook, so the stall lands INSIDE the
  ``paged_step`` dispatch span and the ``dispatch_seconds{program}``
  histogram: the evidence trail looks exactly like a real device
  stall, which is what the flight recorder must be tested against.
* **dump-write OSError** — wrap ``FlightRecorder._write`` to fail the
  next N dump writes (full disk / unwritable dir): the flight
  recorder's contract says a diagnostics failure must never take down
  the serving step.
* **mid-stream cancellation** — schedule ``engine.cancel(rid)`` at a
  step index, before that step runs: cancel during prefill, decode, or
  mid-speculation is just a matter of picking the step.

Everything is host-side and deterministic given the schedule;
``seeded_plan()`` draws a schedule from a seed for randomized-but-
reproducible chaos. ``attach()`` is a context manager that installs
the wrappers and ALWAYS restores the originals — a crashed run must
not leak a failing allocator into the next test.
"""
import contextlib
import time

__all__ = ["FaultInjector", "TrainFaultInjector", "seeded_plan"]


class FaultInjector:
    """A fault schedule + the machinery to install it on one
    ``ContinuousBatchingEngine``. Build the schedule with the
    ``fail_alloc`` / ``slow_step`` / ``cancel_request`` /
    ``fail_dump_writes`` methods (chainable), then::

        inj = FaultInjector().fail_alloc(steps=[4]).cancel_request("r2", 6)
        with inj.attach(cb):
            cb.run()
        assert inj.injected["alloc"] >= 1

    Step and alloc-call indices count from ``attach()`` (not from
    engine construction), so the same injector replays the same plan
    on a warmed engine. ``injected`` counts what actually fired."""

    def __init__(self):
        # schedule
        self._alloc_fail_calls = set()
        self._alloc_fail_steps = set()
        self._slow_steps = {}           # step -> delay_s
        self._cancel_at = {}            # step -> [request ids]
        self._dump_failures = 0
        # runtime (reset per attach)
        self.alloc_calls = 0
        self.steps = 0
        self.injected = {"alloc": 0, "slow": 0, "dump": 0, "cancel": 0}

    # -- the schedule (chainable) ------------------------------------------
    def fail_alloc(self, calls=(), steps=()):
        """Fail ``alloc()`` at these 0-based CALL indices (a transient
        blip — a freed victim block satisfies the retry) and/or for
        every alloc issued during these 0-based STEP indices (a
        sustained outage — preemption can't help, the requester must
        degrade to a per-request failure)."""
        self._alloc_fail_calls.update(int(c) for c in calls)
        self._alloc_fail_steps.update(int(s) for s in steps)
        return self

    def slow_step(self, steps, delay_s=0.01):
        """Stall the step's dispatch by ``delay_s`` host
        seconds on these step indices (inference.set_dispatch_delay:
        the delay shows up inside the paged_step span)."""
        for s in steps:
            self._slow_steps[int(s)] = float(delay_s)
        return self

    def cancel_request(self, request_id, at_step):
        """Issue ``engine.cancel(request_id)`` immediately before step
        ``at_step`` runs — schedule it against the request's phase to
        hit prefill, decode, or mid-speculation."""
        self._cancel_at.setdefault(int(at_step), []).append(request_id)
        return self

    def fail_dump_writes(self, count=1):
        """Make the next ``count`` flight-recorder dump writes raise
        OSError (the full-disk case the recorder must absorb)."""
        self._dump_failures = int(count)
        return self

    # -- installation ------------------------------------------------------
    @contextlib.contextmanager
    def attach(self, cb, flight_recorder=None):
        """Install the wrappers on ``cb`` (and the process flight
        recorder, unless one is passed) for the duration of the with-
        block; restores every original on exit, success or crash."""
        from ..observability import tracing as _tracing
        from .. import inference as _inference

        self.alloc_calls = 0
        self.steps = 0
        self.injected = {"alloc": 0, "slow": 0, "dump": 0, "cancel": 0}
        dump_left = [self._dump_failures]

        orig_alloc = cb.allocator.alloc
        # the allocator's own exhaustion type: the engine's degradation
        # backstop catches exactly this (a bare RuntimeError would
        # surface as a crash — correctly, since only KV exhaustion is
        # a preemptible condition)
        out_of_blocks = getattr(type(cb.allocator), "OutOfBlocks",
                                RuntimeError)

        def alloc_wrapper():
            idx = self.alloc_calls
            self.alloc_calls += 1
            if idx in self._alloc_fail_calls \
                    or self.steps in self._alloc_fail_steps:
                self.injected["alloc"] += 1
                raise out_of_blocks(
                    "BlockAllocator: out of cache blocks [injected]")
            return orig_alloc()

        orig_step = cb.step

        def step_wrapper():
            s = self.steps
            for rid in self._cancel_at.get(s, ()):
                if cb.cancel(rid):
                    self.injected["cancel"] += 1
            delay = self._slow_steps.get(s)
            if delay:
                prev = _inference.set_dispatch_delay("paged_step", delay)
                self.injected["slow"] += 1
            try:
                return orig_step()
            finally:
                self.steps += 1
                if delay:
                    _inference.set_dispatch_delay("paged_step", prev)

        fr = flight_recorder if flight_recorder is not None \
            else _tracing.get_flight_recorder()
        orig_write = fr._write

        def write_wrapper(*args, **kwargs):
            if dump_left[0] > 0:
                dump_left[0] -= 1
                self.injected["dump"] += 1
                raise OSError("injected dump-write failure")
            return orig_write(*args, **kwargs)

        cb.allocator.alloc = alloc_wrapper
        cb.step = step_wrapper
        fr._write = write_wrapper
        try:
            yield self
        finally:
            # instance attributes shadow the originals; remove the
            # shadows (or restore saved bound methods) so the engine
            # and recorder leave exactly as they came
            cb.allocator.alloc = orig_alloc
            cb.step = orig_step
            del fr._write


class TrainFaultInjector:
    """Deterministic faults for the TRAINING loop: the three production
    failure modes the train-health gate (tools/torch_train_monitor.py)
    must prove the monitor catches:

    * **NaN'd batch** — ``nan_batch(step)`` corrupts that step's host
      batch with out-of-vocab token ids. The embedding gather
      (``nn.functional.embedding``, as the JAX package's fill-mode
      ``jnp.take``) reads NaN rows for them, so the loss
      and every gradient go non-finite THAT step and the parameters
      are poisoned from then on — the real shape of a corrupted data
      shard, and exactly what the ``non_finite`` detector must catch
      at the first poisoned step (training continues; degrade, don't
      crash).
    * **lr spike** — ``lr_spike(step, factor)`` routes that step
      through the train step's ``lr_scale=``: one update at
      ``factor`` x the configured lr blows the parameters up (finite),
      so the NEXT step's loss/grad-norm jump out of the rolling
      baseline — the ``grad_spike`` + ``loss_spike`` detectors' case.
    * **throttled loader** — ``stall_loader(batch_index, delay_s)``
      sleeps inside the batch iterator (wrap it with
      ``wrap_loader``), upstream of the instrumented loader's wait
      measurement, so the stall is indistinguishable from a real
      starved input pipeline and must fire the ``data_stall`` dump.

    Host-side and exactly reproducible: the schedule is step/batch
    indices, ``injected`` counts what actually fired."""

    # out-of-vocab by orders of magnitude: no real vocab reaches here,
    # and the id still fits int32
    OOV_TOKEN = 1 << 30

    def __init__(self):
        self._nan_batch_steps = set()
        self._lr_spikes = {}            # step -> factor
        self._loader_stalls = {}        # batch index -> delay_s
        self.injected = {"nan_batch": 0, "lr_spike": 0,
                         "loader_stall": 0}

    # -- schedule builders (chainable) ------------------------------------
    def nan_batch(self, step, tokens=4):
        self._nan_batch_steps.add(int(step))
        self._nan_tokens = int(tokens)
        return self

    def lr_spike(self, step, factor=64.0):
        self._lr_spikes[int(step)] = float(factor)
        return self

    def stall_loader(self, batch_index, delay_s=0.5):
        self._loader_stalls[int(batch_index)] = float(delay_s)
        return self

    # -- hooks the training loop applies ----------------------------------
    def adjust_batch(self, step, batch):
        """Corrupt the HOST batch (numpy dict, before `batch_to_device`) when
        this step is scheduled; returns the batch either way."""
        if int(step) in self._nan_batch_steps:
            ids = batch["input_ids"].copy()
            n = min(getattr(self, "_nan_tokens", 4), ids.shape[-1])
            ids[0, :n] = self.OOV_TOKEN
            batch = dict(batch, input_ids=ids)
            self.injected["nan_batch"] += 1
        return batch

    def lr_scale_for(self, step):
        """The ``lr_scale=`` to pass the train step at this step (None
        = the configured lr)."""
        factor = self._lr_spikes.get(int(step))
        if factor is None:
            return None
        self.injected["lr_spike"] += 1
        return factor

    def wrap_loader(self, iterable):
        """Throttle scheduled batches. Wrap the RAW iterator and feed
        the result to the instrumented loader, so the injected delay
        lands inside the measured data wait."""
        def gen():
            for i, b in enumerate(iterable):
                delay = self._loader_stalls.get(i)
                if delay:
                    self.injected["loader_stall"] += 1
                    time.sleep(delay)
                yield b
        return gen()


def seeded_plan(seed, steps, alloc_fail_rate=0.0, slow_rate=0.0,
                slow_delay_s=0.005, dump_failures=0):
    """Draw a randomized-but-reproducible fault schedule: each step
    independently gets an alloc outage / a dispatch stall with the
    given rates. Same seed -> same plan -> same engine behavior (the
    chaos gate's determinism rests on this)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    inj = FaultInjector()
    for s in range(int(steps)):
        if rng.random() < alloc_fail_rate:
            inj.fail_alloc(steps=[s])
        if rng.random() < slow_rate:
            inj.slow_step([s], slow_delay_s)
    if dump_failures:
        inj.fail_dump_writes(dump_failures)
    return inj
