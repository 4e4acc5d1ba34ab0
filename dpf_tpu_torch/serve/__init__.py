"""Throughput-oriented serving (port of ``dpf_tpu/serve``, started).

``ServingEngine`` (engine.py) pipelines host packing against the card
under a bounded in-flight window: pinned key staging, asynchronous
uploads, one CUDA event a dispatched part, cooperative deadlines, a
latency ring and admission control (``LoadShed``); ``Buckets``
(buckets.py) bounds the batch shapes under ragged sizes; ``loadgen.py``
makes deterministic open-loop arrival traces; ``SchemeRouter``
(router.py) sends each batch to the cheapest construction by a live
cost model; ``faults.py`` has seeded fault injection and the recovery
machinery (``RetryPolicy``, ``CircuitBreaker``, ``EngineSupervisor``);
``bench_serve.py`` compares the engine with the blocking loop and
``bench_load.py`` races the router against the sticky engine under a
bursty trace, every answer gated against ``DPF.eval_cpu``, and
``bench_chaos.py`` replays that trace under escalating fault plans to
measure availability.  Built via ``DPF.serving_engine()``.

The multi-tenant tier sits on top: ``TableRegistry`` (registry.py) holds
named, versioned tables with LRU residency on the card under a byte
budget (and ``GranuleStore`` pages one table by row granules),
``TenantRouter`` (tenant.py) runs one isolated ``SchemeRouter`` per
tenant under a weighted-fair deficit-round-robin scheduler, and
``bench_multitenant.py`` measures the noisy-neighbour isolation, and
``bench_pir.py`` batch-PIR (``apps.batch_pir``) end to end.  The
``bench_bigtable``, ``bench_multichip`` and ``bench_multihost`` scripts
of ``dpf_tpu/serve`` are not ported yet.
"""

from .buckets import Buckets  # noqa: F401
from .engine import (EngineClosed, EngineFuture, LoadShed,  # noqa: F401
                     ServingEngine)
from .faults import (CircuitBreaker, EngineDead, EngineSupervisor,  # noqa: F401
                     FaultError, FaultInjector, FaultPlan, FaultSpec,
                     InjectedCompileError, InjectedDispatchError,
                     RetryPolicy, submit_with_retry)
from .loadgen import Arrival, make_trace  # noqa: F401
from .registry import TableLease, TableRegistry, TableVersion  # noqa: F401
from .router import RouteDecision, SchemeRouter  # noqa: F401
from .tenant import TenantFuture, TenantRouter, TenantSpec  # noqa: F401
