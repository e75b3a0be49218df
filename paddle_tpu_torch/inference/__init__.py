from .admission import (AdmissionConfig, AdmissionController, EngineLoad,
                        TenantPolicy, priority_rank)
from .cache_tier import HostTier
from .serving import ContinuousBatchingEngine, EngineFenced, GenRequest

__all__ = ["ContinuousBatchingEngine", "GenRequest", "EngineFenced",
           "AdmissionConfig", "AdmissionController", "EngineLoad",
           "TenantPolicy", "priority_rank", "HostTier"]
