from repro_torch.ft_runtime.monitor import (FaultRateMonitor, RequestFaultStats,
                                            ServeFaultTelemetry,
                                            StragglerMonitor)
