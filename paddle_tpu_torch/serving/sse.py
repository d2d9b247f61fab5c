"""Server-Sent Events wire format (the gateway's streaming half).

A copy of ``paddle_tpu/serving/sse.py`` (stdlib only): the bytes on the
wire are the JAX gateway's.

One event type per engine emission:

* ``accepted`` — the request cleared submit() validation and entered
  the queue; carries the (possibly gateway-assigned) request id so a
  client that did not pick its own id learns where to point DELETE.
* ``token`` — one committed engine emission: the first token a
  finished prefill samples, or a verified decode span (mandatory token
  + accepted speculative drafts). Carries the engine step it landed
  on and a running event index, so a client (and the gateway gate) can
  check ordering against the span ring.
* ``end`` — the request's structured terminal record
  (``RequestResult``): status/reason/preemptions plus the full token
  list, so a client that missed a frame can reconcile.

Format per the WHATWG EventSource framing: ``event:`` + ``data:``
lines, blank-line terminated, one JSON object per event. stdlib-only
both ways — the parser below is what the gate's asyncio client and
the tests consume streams with.
"""
import json

__all__ = ["format_event", "parse_events", "iter_events"]


def format_event(event, data):
    """One SSE frame as bytes: ``event: <type>`` + one ``data:`` line
    of JSON. The payload is a single json.dumps line, so the multi-line
    ``data:`` continuation rule never applies."""
    payload = json.dumps(data, sort_keys=True)
    return f"event: {event}\ndata: {payload}\n\n".encode("utf-8")


def iter_events(lines):
    """Incremental SSE decode over an iterable of text lines (newline
    stripped or not): yields (event_type, payload_dict) per complete
    frame. Tolerates comment lines (``:`` prefix) and bare data
    frames (type defaults to ``message``, per the spec)."""
    etype, data = None, []
    for raw in lines:
        line = raw.rstrip("\r\n") if isinstance(raw, str) \
            else raw.decode("utf-8").rstrip("\r\n")
        if line.startswith(":"):
            continue
        if line == "":
            if data:
                yield (etype or "message",
                       json.loads("\n".join(data)))
            etype, data = None, []
            continue
        field, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if field == "event":
            etype = value
        elif field == "data":
            data.append(value)
    if data:
        yield (etype or "message", json.loads("\n".join(data)))


def parse_events(text):
    """The whole-buffer form of :func:`iter_events` (bytes or str in,
    list of (event, payload) out) — what tests assert against."""
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    return list(iter_events(text.splitlines(keepends=True)))
