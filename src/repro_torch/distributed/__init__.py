from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import (batch_sharding, cache_shardings,
                                              dp_axes, gather_tree,
                                              param_shardings, shard_tree,
                                              spec_for_param)
from repro_torch.distributed.collectives import compressed_psum, quantize_int8
from repro_torch.distributed.context import DistContext, current, use_context
