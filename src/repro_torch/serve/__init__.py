"""The multi-tenant serving engine (MAGMA as the job scheduler), ported
from ``repro.serve``."""
from repro_torch.serve.engine import (
    PRIORITY_CLASSES, ServeJob, Submesh, Tenant, TenantSLO, MultiTenantEngine,
    default_submeshes, job_costs)

__all__ = ["PRIORITY_CLASSES", "ServeJob", "Submesh", "Tenant", "TenantSLO",
           "MultiTenantEngine", "default_submeshes", "job_costs"]
