"""``repro_torch.serving`` — the serving surface of the torch port.

Sessions (:func:`serve` → :class:`ServingSession` → :class:`RequestHandle`)
over sharded, SMR-isolated engines on one device; named admission/eviction
policies; the fault registry (:class:`FaultSpec` / :func:`parse_fault`) and
the session watchdog behind ``ServingConfig.watchdog`` (DESIGN.md §14).
"""

from .config import PriorityClass, ServingConfig, parse_priority_class
from .engine import Request
from .faults import FaultSpec, fault_kinds, parse_fault
from .policies import (
    admission_policies,
    as_admission_policy,
    as_eviction_policy,
    as_scheduler_policy,
    eviction_policies,
    scheduler_policies,
)
from .sampling import (
    SAMPLING_POLICIES,
    GreedySampling,
    SamplingPolicy,
    TemperatureSampling,
    TopKSampling,
    TopPSampling,
    as_sampling_policy,
    sampling_policies,
)
from .session import (
    PrefixRouter,
    RequestHandle,
    ServingSession,
    ShardedEngine,
    serve,
)
from .watchdog import SessionWatchdog

__all__ = [
    "serve",
    "ServingConfig",
    "PriorityClass",
    "parse_priority_class",
    "ServingSession",
    "RequestHandle",
    "ShardedEngine",
    "PrefixRouter",
    "Request",
    "SessionWatchdog",
    "FaultSpec",
    "fault_kinds",
    "parse_fault",
    "admission_policies",
    "eviction_policies",
    "scheduler_policies",
    "as_admission_policy",
    "as_eviction_policy",
    "as_scheduler_policy",
    "SamplingPolicy",
    "GreedySampling",
    "TemperatureSampling",
    "TopKSampling",
    "TopPSampling",
    "SAMPLING_POLICIES",
    "sampling_policies",
    "as_sampling_policy",
]
