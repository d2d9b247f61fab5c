"""Registry exporters: Prometheus text, JSON snapshot, chrome counters.

A copy of ``paddle_tpu/observability/exporters.py`` (stdlib only), kept
apart so the PyTorch package imports nothing of the JAX package.

Three consumers, three formats:

* ``to_prometheus`` — the scrape endpoint / pushgateway format
  (text exposition 0.0.4): ``# HELP`` / ``# TYPE`` headers, labeled
  samples, histogram ``_bucket{le=...}`` / ``_sum`` / ``_count`` series
  with cumulative bucket counts.
* ``to_json`` — one self-describing dict for dashboards and for
  committing bench snapshots (BASELINE.md); stable key order.
* ``chrome_counter_events`` — the registry's timeline ring as
  ``"ph": "C"`` counter events, ready to merge into a chrome trace
  beside the request lanes of ``tracing.chrome_span_events``.

stdlib only, same reason as metrics.py.
"""
import json
import math
import re
import time

from .metrics import get_registry

__all__ = ["to_prometheus", "to_json", "chrome_counter_events",
           "parse_prometheus"]


def _esc_label(v):
    """Label-VALUE escaping (text exposition 0.0.4): backslash, double
    quote, newline — the value sits inside double quotes."""
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _esc_help(v):
    """HELP-text escaping is a DIFFERENT rule in the same format:
    only backslash and newline. Help text is not quoted, so escaping
    `"` (as the old shared `_esc` did) rendered help strings containing
    quotes as literal `\\"` in every scrape."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _labelstr(names, values, extra=()):
    pairs = [f'{n}="{_esc_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_esc_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(v):
    if v != v:                       # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def to_prometheus(registry=None):
    """Text exposition format; one string ready to serve at /metrics."""
    registry = registry or get_registry()
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        # copy child state under the lock: a concurrent observe() between
        # reading the buckets and the count would otherwise emit a scrape
        # where x_count disagrees with the +Inf bucket (which Prometheus
        # treats as the count — histogram_quantile turns that into NaN)
        with registry._lock:
            if m.kind == "histogram":
                children = {k: (list(c.bucket_counts), c.sum, c.count)
                            for k, c in m._children.items()}
            else:
                children = {k: c.value for k, c in m._children.items()}
        for key, child in sorted(children.items()):
            if m.kind == "histogram":
                bucket_counts, csum, ccount = child
                cum = 0
                for edge, n in zip(m.buckets, bucket_counts):
                    cum += n
                    lines.append(
                        f"{m.name}_bucket"
                        + _labelstr(m.labelnames, key,
                                    extra=[("le", _fmt(edge))])
                        + f" {cum}")
                cum += bucket_counts[-1]
                lines.append(
                    f"{m.name}_bucket"
                    + _labelstr(m.labelnames, key, extra=[("le", "+Inf")])
                    + f" {cum}")
                lines.append(f"{m.name}_sum"
                             + _labelstr(m.labelnames, key)
                             + f" {_fmt(csum)}")
                lines.append(f"{m.name}_count"
                             + _labelstr(m.labelnames, key)
                             + f" {ccount}")
            else:
                lines.append(f"{m.name}"
                             + _labelstr(m.labelnames, key)
                             + f" {_fmt(child)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(registry=None, indent=None):
    """JSON string: {"time": unix_seconds, "metrics": snapshot()}."""
    registry = registry or get_registry()
    return json.dumps({"time": time.time(),
                       "metrics": registry.snapshot()},
                      indent=indent, sort_keys=True)


_SAMPLE_RE = re.compile(
    r'^([A-Za-z_:][A-Za-z0-9_:]*)(\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:\\.|[^"\\])*)"')


_UNESC_RE = re.compile(r"\\(.)")


def _unesc_label(v):
    # ONE left-to-right pass: sequential .replace() calls corrupt a
    # literal backslash-then-n ('\\' + 'n' escapes to '\\\\n', which a
    # naive '\\n'-first pass turns into backslash + real newline).
    # Unknown escapes keep their backslash, like Prometheus' parser.
    return _UNESC_RE.sub(
        lambda m: {"n": "\n", '"': '"', "\\": "\\"}.get(
            m.group(1), "\\" + m.group(1)), v)


def _parse_value(v):
    if v == "+Inf":
        return math.inf
    if v == "-Inf":
        return -math.inf
    if v == "NaN":
        return math.nan
    return float(v)


def parse_prometheus(text):
    """Parse text exposition 0.0.4 back into
    ``{family: {"kind": str|None, "help": str|None,
    "samples": [(name, {label: value}, float), ...]}}``.

    The inverse of :func:`to_prometheus`, close enough for a scraper:
    histogram series land under their family name (``x_bucket`` /
    ``x_sum`` / ``x_count`` grouped under ``x`` once a ``# TYPE x
    histogram`` header announced it; standalone they are their own
    family). This is what the gateway gates validate /metrics with —
    stdlib-only, same contract as the rest of the module."""
    out = {}
    histograms = set()

    def fam(name):
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) \
                    and base[:-len(suffix)] in histograms:
                base = base[:-len(suffix)]
                break
        return out.setdefault(base, {"kind": None, "help": None,
                                     "samples": []})

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            out.setdefault(name, {"kind": None, "help": None,
                                  "samples": []})["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            out.setdefault(name, {"kind": None, "help": None,
                                  "samples": []})["kind"] = kind.strip()
            if kind.strip() == "histogram":
                histograms.add(name)
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, _, labelstr, value = m.groups()
        labels = {k: _unesc_label(v)
                  for k, v in _LABEL_RE.findall(labelstr or "")}
        fam(name)["samples"].append((name, labels, _parse_value(value)))
    return out


def chrome_counter_events(registry=None, pid=None, since_us=None,
                          until_us=None):
    """Timeline samples as chrome-trace counter events.

    One ``{"ph": "C"}`` event per recorded sample, so gauges plot as a
    stepped series alongside the profiler's "X" host ranges. ``dur`` and
    ``tid`` carry 0: counters have no duration, and keeping the keys
    means every event in the merged stream has the same shape (the
    profiler's export contract). ``since_us``/``until_us`` (perf_counter
    microseconds, the samples' timebase) window the ring — the profiler
    passes its record window so a short trace doesn't drag in every
    sample since process start."""
    registry = registry or get_registry()
    if pid is None:
        import os
        pid = os.getpid()
    return [{"name": name, "ph": "C", "ts": ts, "dur": 0,
             "pid": pid, "tid": 0, "cat": "metric",
             "args": {"value": value}}
            for ts, name, value in registry.timeline()
            if (since_us is None or ts >= since_us)
            and (until_us is None or ts <= until_us)]
