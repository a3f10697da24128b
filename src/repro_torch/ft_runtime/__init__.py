from repro_torch.ft_runtime.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore, save)
from repro_torch.ft_runtime.elastic import MeshPlan, build_mesh, plan_mesh
from repro_torch.ft_runtime.monitor import (FaultRateMonitor, RequestFaultStats,
                                            ServeFaultTelemetry,
                                            StragglerMonitor)
