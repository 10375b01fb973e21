"""Multi-tenant FHE serving runtime (request queue → slot batcher →
key cache → pipelined executor), mirroring `repro.runtime`.

* ``queue``         admission control + per-tenant request queues
* ``batcher``       packs pending requests into CKKS slot groups
* ``keycache``      capacity-aware LRU over evk / plaintext footprints
* ``compile_cache`` trace → PipelineSchedule memoization
* ``executor``      round-based engine over the analytic MemoryModel
                    backend or the real-CKKS ciphertext backend
* ``ciphertext_backend``  batched encrypted execution on a torch device
* ``metrics``       p50/p99 latency, throughput, cache hit rate,
                    partition occupancy

Entry point: ``python -m repro_torch.launch.serve_fhe``.
"""
from repro_torch.runtime.queue import AdmissionQueue, Request, RequestStatus
from repro_torch.runtime.batcher import Batch, BatchPolicy, SlotBatcher
from repro_torch.runtime.keycache import KeyCache
from repro_torch.runtime.compile_cache import CompileCache, trace_fingerprint
from repro_torch.runtime.ciphertext_backend import CiphertextBackend
from repro_torch.runtime.executor import (AnalyticBackend, PipelinedExecutor,
                                          Workload, resolve_backend)
from repro_torch.runtime.metrics import LatencyStats, MetricsRegistry

__all__ = [
    "AdmissionQueue", "Request", "RequestStatus",
    "Batch", "BatchPolicy", "SlotBatcher",
    "KeyCache", "CompileCache", "trace_fingerprint",
    "AnalyticBackend", "CiphertextBackend",
    "PipelinedExecutor", "Workload", "resolve_backend",
    "LatencyStats", "MetricsRegistry",
]
