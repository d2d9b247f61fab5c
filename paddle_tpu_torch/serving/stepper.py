"""EngineStepper — the dedicated thread that owns the serving engine.

The PyTorch port's copy of ``paddle_tpu/serving/stepper.py``.

The ContinuousBatchingEngine is a host-side scheduler around one
step program: correct under exactly one caller at a time
(submit/cancel/step all mutate the same tables). The gateway is an
asyncio process full of concurrent handlers — so all engine access
funnels through this one thread:

* handlers enqueue COMMANDS (submit / cancel / an arbitrary
  introspection callable) and get a ``concurrent.futures.Future``
  back (``asyncio.wrap_future`` bridges it into a coroutine);
* the thread drains commands, then runs ``engine.step()`` whenever
  work exists, and parks on a condition variable when idle — zero
  busy-wait, sub-millisecond submit-to-step handoff;
* the engine's ``on_token`` / ``on_terminal`` hooks (fired inside
  step(), on this thread) fan out to per-request subscribers — plain
  callables taking one event dict, so this module stays asyncio-free
  (the gateway's subscriber is a ``loop.call_soon_threadsafe`` bridge
  into an ``asyncio.Queue``).

Failure discipline: a step() crash is not swallowed — every live subscriber
gets a structured ``end`` event (status ``failed``, reason
``engine_error``), the stepper records the exception and stops, and
every later command future fails with it. Silence is the one
forbidden outcome.

stdlib-only at import (threading + collections); the engine itself is
constructed by the caller, torch and all.
"""
import collections
import concurrent.futures
import threading

__all__ = ["EngineStepper"]


class _Subscription:
    """Per-request fanout target: wraps the caller's event callable
    with the running token-event index the SSE contract exposes."""

    __slots__ = ("emit", "events", "tokens")

    def __init__(self, emit):
        self.emit = emit
        self.events = 0     # token events delivered so far
        self.tokens = 0     # tokens delivered so far


class EngineStepper:
    """Own a ContinuousBatchingEngine on a dedicated thread.

    ``submit(request, on_event=...)`` / ``cancel(request_id)`` /
    ``call(fn)`` return concurrent futures resolved on the stepper
    thread; ``start()`` / ``stop()`` bound the thread's lifetime.
    """

    def __init__(self, engine, name="engine-stepper"):
        self.engine = engine
        self._cond = threading.Condition()
        self._commands = collections.deque()
        self._subs = {}             # request_id -> _Subscription
        self._stopping = False
        self._hold = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self.steps = 0
        self.error = None           # the exception that stopped us, if any
        engine.on_token = self._on_token
        engine.on_terminal = self._on_terminal

    # -- public API (any thread) -------------------------------------------
    def start(self):
        self._thread.start()
        return self

    def stop(self, join=True, timeout=30.0):
        """Stop stepping after the current tick; pending commands still
        drain (their futures resolve), in-flight requests stay wherever
        the last step left them."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if join and self._thread.is_alive():
            self._thread.join(timeout)

    @property
    def running(self):
        # `error` is written by the step thread under `_cond` — read
        # it under the same lock, or a caller polling `running` can
        # observe the liveness flip before the error lands and report
        # "healthy" for a dying stepper
        with self._cond:
            err = self.error
        return self._thread.is_alive() and err is None

    def hold(self):
        """Pause stepping (commands still drain): submissions enqueue
        into the engine without a step running between them, so a
        caller can make a BATCH of arrivals land on one admission pass
        — what the gateway gates use to keep the step-bucket
        sequence deterministic under wall-clock HTTP arrivals."""
        with self._cond:
            self._hold = True
            self._cond.notify_all()

    def release(self):
        with self._cond:
            self._hold = False
            self._cond.notify_all()

    def submit(self, request, on_event=None):
        """Queue a submit; the future resolves with the engine's
        admission verdict ("queued" / "rejected"). ``on_event`` (a
        callable taking one dict) subscribes to the request's token /
        terminal fanout — registered BEFORE submit runs, so even a
        structured rejection delivers its ``end`` event."""
        return self._command(("submit", request, on_event))

    def cancel(self, request_id):
        """Queue a cancel; future resolves with engine.cancel()'s
        bool (found-live)."""
        return self._command(("cancel", request_id))

    def call(self, fn):
        """Run ``fn(engine)`` between steps on the stepper thread —
        the control plane's serialized peek (allocator gauges,
        declare_warm, monitor.force)."""
        return self._command(("call", fn))

    def _command(self, cmd):
        fut = concurrent.futures.Future()
        with self._cond:
            if self.error is not None:
                fut.set_exception(self.error)
                return fut
            if self._stopping:
                fut.set_exception(RuntimeError("stepper is stopping"))
                return fut
            self._commands.append((cmd, fut))
            self._cond.notify_all()
        return fut

    # -- fanout (stepper thread, called from inside engine.step) ----------
    def _on_token(self, request_id, tokens, step):
        sub = self._subs.get(request_id)
        if sub is None:
            return
        ev = {"type": "token", "request": request_id,
              "tokens": list(tokens), "step": int(step),
              "index": sub.events}
        sub.events += 1
        sub.tokens += len(tokens)
        sub.emit(ev)

    def _on_terminal(self, request_id, result):
        sub = self._subs.pop(request_id, None)
        if sub is None:
            return
        sub.emit({"type": "end", "request": request_id,
                  "status": result.status, "reason": result.reason,
                  "preemptions": result.preemptions,
                  "tokens": list(result)})

    def _fail_subscribers(self, exc):
        """Structured fanout for a crashed step: every live stream gets
        a terminal event instead of silence (the reason label is a
        fixed literal)."""
        subs, self._subs = self._subs, {}
        for rid, sub in subs.items():
            sub.emit({"type": "end", "request": rid, "status": "failed",
                      "reason": "engine_error", "preemptions": 0,
                      "tokens": [], "error": str(exc)})

    # -- the loop (stepper thread) -----------------------------------------
    def _execute(self, cmd, fut):
        if not fut.set_running_or_notify_cancel():
            return
        try:
            kind = cmd[0]
            if kind == "submit":
                _, request, on_event = cmd
                rid = request.request_id
                if on_event is not None:
                    if rid in self._subs:
                        # refuse up front: overwriting would orphan the
                        # LIVE stream already subscribed under this id
                        raise ValueError(
                            f"request_id {rid!r} already streaming")
                    self._subs[rid] = _Subscription(on_event)
                try:
                    fut.set_result(self.engine.submit(request))
                except BaseException:
                    # a submit that RAISED (duplicate id, oversized
                    # request) never reaches the engine: drop the
                    # subscription so the map can't leak
                    self._subs.pop(rid, None)
                    raise
            elif kind == "cancel":
                fut.set_result(self.engine.cancel(cmd[1]))
            else:
                fut.set_result(cmd[1](self.engine))
        except BaseException as e:     # noqa: B036 - forwarded, not dropped
            # command failures are the CALLER's to handle: the
            # exception crosses to the awaiting handler through the
            # future (nothing is swallowed), and the stepper keeps
            # serving everyone else
            if not fut.done():
                fut.set_exception(e)

    def _run(self):
        while True:
            with self._cond:
                while (not self._commands and not self._stopping
                       and (self._hold
                            or not (self.engine.queue
                                    or self.engine.num_active))):
                    self._cond.wait()
                cmds = list(self._commands)
                self._commands.clear()
                stopping = self._stopping
                held = self._hold
            for cmd, fut in cmds:
                self._execute(cmd, fut)
            if stopping:
                return
            if held:
                continue
            if self.engine.queue or self.engine.num_active:
                try:
                    self.engine.step()
                    self.steps += 1
                except Exception as e:
                    # step() crashed: fan a structured `failed`
                    # terminal out to every subscriber, record the
                    # exception for later commands, and stop — the
                    # one thing this loop must never do is swallow
                    # the error and retry forever
                    self._fail_subscribers(e)
                    with self._cond:
                        self.error = e
                        self._stopping = True
                        for cmd, fut in self._commands:
                            if not fut.done():
                                fut.set_exception(e)
                        self._commands.clear()
                    return
