"""Hand-written CUDA kernels of the port, each beside its plain version.
(The contiguous kernel's wrapper is ``kernels.efta_attention.
efta_attention``; it is not re-exported here, where its name would shadow
its module.)"""
from repro_torch.kernels.efta_attention import (efta_attention_rows,
                                                efta_attention_torch,
                                                fault_descriptor)
from repro_torch.kernels.efta_paged import (NO_WINDOW, PagedReport,
                                            efta_paged_attention,
                                            efta_paged_attention_torch,
                                            paged_fault_descriptor)
from repro_torch.kernels.ops import IMPLS, attention
