"""Hand-written CUDA kernels of the port, each beside its plain version."""
from repro_torch.kernels.efta_paged import (NO_WINDOW, PagedReport,
                                            efta_paged_attention,
                                            efta_paged_attention_torch,
                                            paged_fault_descriptor)
