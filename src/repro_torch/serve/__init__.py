from repro_torch.serve.blocks import BlockPool, PrefixCache
from repro_torch.serve.cache import KVCachePool
from repro_torch.serve.draft import (DraftModelProposer, DraftStats,
                                     NGramProposer, build_proposer)
from repro_torch.serve.engine import EngineStats, ServeEngine, batch_faults
from repro_torch.serve.paged import (PagedCacheStats, PagedKVPool,
                                     PagedServeEngine)
from repro_torch.serve.sampling import (SamplingParams, sample_tokens,
                                        speculative_accept, target_probs)
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler, Request,
                                         RequestState)
from repro_torch.serve.step import (greedy_generate, make_decode_step,
                                     make_prefill_step)
