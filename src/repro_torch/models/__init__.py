from repro_torch.models.api import Model, build_model, resolve_device
from repro_torch.models.attention import KVCache, PagedKVCache, init_cache
from repro_torch.models.convert import from_reference_params
from repro_torch.models.transformer import forward, init_params, layer_flags
