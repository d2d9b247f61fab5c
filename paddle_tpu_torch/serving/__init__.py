"""paddle_tpu_torch.serving — the async HTTP/SSE front door of the port.

The PyTorch port's counterpart of ``paddle_tpu/serving``: the production
gateway over the port's continuous-batching engine. A dedicated stepper
thread owns the engine (stepper.py), an asyncio HTTP/1.1 server streams
per-token SSE and serves the observability control plane (gateway.py —
/v1/generate, /v1/requests/{id}, /metrics, /slo, /requests, /dumps,
/healthz), a router fronts N replicas with the stepper's surface
(router.py), and sse.py is the framing both sides share.

Contract: stdlib-only at import time, same as the JAX package's — torch
and numpy are touched lazily at request time.

Quick tour::

    from paddle_tpu_torch import serving

    stepper = serving.EngineStepper(cb).start()   # cb: the engine
    gw = serving.ServingGateway(stepper, monitor=mon, port=8000)
    # ... await gw.start(); await gw.serve_forever()
    # or, blocking: serving.run_gateway(cb, port=8000, monitor=mon)

Entrypoint: ``python examples/torch_serve_gateway.py`` (on the GPU).
Gates: ``tools/torch_serve_gates.py --check tools/serve_gateway.json``
(and ``serve_replica.json``, ``serve_chaos.json``).
"""
from .sse import format_event, iter_events, parse_events
from .stepper import EngineStepper
from .router import (EngineRouter, RoutingPolicy, RoundRobinPolicy,
                     LeastLoadedPolicy, PrefixAffinityPolicy, POLICIES)
from .gateway import (ServingGateway, run_gateway,
                      validate_generate_body, validate_healthz,
                      HEALTHZ_SCHEMA, REQUESTS_SCHEMA, DUMPS_SCHEMA,
                      STATUS_HTTP)

__all__ = [
    "format_event", "iter_events", "parse_events",
    "EngineStepper", "ServingGateway", "run_gateway",
    "EngineRouter", "RoutingPolicy", "RoundRobinPolicy",
    "LeastLoadedPolicy", "PrefixAffinityPolicy", "POLICIES",
    "validate_generate_body", "validate_healthz",
    "HEALTHZ_SCHEMA", "REQUESTS_SCHEMA", "DUMPS_SCHEMA", "STATUS_HTTP",
    "sse", "stepper", "gateway", "router",
]
