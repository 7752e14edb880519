"""The port's own copy of ``repro.runtime``, unchanged in behaviour: the
port imports nothing of ``repro``."""

from .fault_tolerance import (ElasticPlan, HeartbeatMonitor, RecoveryPlan,
                              StragglerMitigator, plan_elastic_mesh)

__all__ = ["ElasticPlan", "HeartbeatMonitor", "RecoveryPlan",
           "StragglerMitigator", "plan_elastic_mesh"]
