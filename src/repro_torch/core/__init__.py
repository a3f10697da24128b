"""Core EFTA library: fault model, checksum algebra, configuration."""
from repro_torch.core.checksum import (Checksums, block_fold_bad, encode_kv,
                                       encode_kv_tile, fold1, fold2,
                                       kv_block_threshold, verify_block)
from repro_torch.core.efta import MASK_VALUE, EFTAConfig, FTReport
from repro_torch.core.fault import FaultSpec, Site, flip_bit_at
