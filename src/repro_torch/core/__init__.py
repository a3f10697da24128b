"""Core EFTA library: fault model, checksum algebra, configuration and the
plain-PyTorch EFTA attention."""
from repro_torch.core.checksum import (LOG_PROD_FLOOR, Checksums, Verdict,
                                       block_fold_bad, encode_cols, encode_kv,
                                       encode_kv_tile, fold1, fold2, foldprod,
                                       kv_block_threshold, verify_and_correct,
                                       verify_block, verify_product,
                                       verify_product_log)
from repro_torch.core.efta import (MASK_VALUE, EFTAConfig, FTReport,
                                   efta_attention, efta_mha,
                                   reference_attention)
from repro_torch.core.fault import (FaultSpec, Site, flip_bit_at, inject,
                                    random_fault)
