from repro_torch.models.api import Model, build_model, resolve_device
from repro_torch.models.attention import (KVCache, PagedKVCache, init_cache,
                                          paged_rollback)
from repro_torch.models.convert import (from_reference_params,
                                        from_reference_train_state)
from repro_torch.models.transformer import (VLMCache, forward, init_params,
                                            layer_flags)
