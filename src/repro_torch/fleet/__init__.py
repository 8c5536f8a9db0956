"""repro_torch.fleet - trace-driven multi-engine serving fleet.

Generalizes the paper's per-device time-slice placement loop to a pool of
N serve engines fed by realistic traffic: arrival traces
(:mod:`repro_torch.fleet.traces`), per-engine load forecasting
(:mod:`repro_torch.fleet.forecast`) driving *proactive* weight migration
through the scheduler's ``lookup_tasks`` hook, an SLO-aware router with
admission control (:mod:`repro_torch.fleet.router`), the two-level cell
router + autoscaler that scale the loop to hundreds->thousands of engines
(:mod:`repro_torch.fleet.hierarchy`, DESIGN.md SS.9), multi-tenant DAG
co-scheduling (:mod:`repro_torch.fleet.dag`, DESIGN.md SS.11) and
tail-latency/energy aggregation (:mod:`repro_torch.fleet.metrics`).

Fleets are canonically constructed through ``repro_torch.api.fleet``
(flat), ``repro_torch.api.hierarchical_fleet`` (cells) and
``repro_torch.api.dag_fleet``: substrate registry + shared placement LUT
per engine shape, built on the fleet's device; optionally a real
``HeteroServeEngine`` per worker so placements are functionally
exercised by re-tiering weights and decoding tokens on that device.
The fleet logic itself is host code (numpy), identical to the JAX
package's.
"""
from __future__ import annotations

from repro_torch.fleet.dag import (DAG_SPECS,  # noqa: F401
                                   DagCoScheduler, DagFleet, DagRequest,
                                   DagResult, DagSpec, DagTrace,
                                   StageRequest, StageSpec, Tenant,
                                   TenantRegistry, dag_arrivals,
                                   default_tenants, make_dag_spec,
                                   tenant_breakdown)
from repro_torch.fleet.forecast import (FORECASTERS,  # noqa: F401
                                        Forecaster, make_forecaster)
from repro_torch.fleet.hierarchy import (CELL_POLICIES,  # noqa: F401
                                         AutoscaleConfig, Cell,
                                         CellAutoscaler, CellRouter,
                                         HierarchicalFleet,
                                         HierarchyResult, ScaleEvent)
from repro_torch.fleet.metrics import (FleetSummary,  # noqa: F401
                                       class_breakdown, summarize)
from repro_torch.fleet.router import (POLICIES, EngineWorker,  # noqa: F401
                                      Fleet, FleetRequest, FleetResult,
                                      FleetRouter)
from repro_torch.fleet.traces import (BURSTY, TRACES, Trace,  # noqa: F401
                                      make_trace)

__all__ = [
    "Trace", "make_trace", "TRACES", "BURSTY",
    "Forecaster", "make_forecaster", "FORECASTERS",
    "EngineWorker", "FleetRouter", "Fleet", "FleetRequest", "FleetResult",
    "POLICIES", "FleetSummary", "summarize", "class_breakdown",
    "Cell", "CellRouter", "CellAutoscaler", "AutoscaleConfig",
    "HierarchicalFleet", "HierarchyResult", "ScaleEvent", "CELL_POLICIES",
    "DagSpec", "StageSpec", "DAG_SPECS", "make_dag_spec",
    "Tenant", "TenantRegistry", "default_tenants",
    "DagTrace", "dag_arrivals", "DagRequest", "StageRequest",
    "DagCoScheduler", "DagFleet", "DagResult", "tenant_breakdown",
]
