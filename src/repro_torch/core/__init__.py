"""Core EFTA library: fault model, checksum algebra, configuration, the
plain-PyTorch EFTA attention, the decoupled baseline, ABFT for linear
layers and the SEU campaigns."""
from repro_torch.core.checksum import (LOG_PROD_FLOOR, Checksums, Verdict,
                                       block_fold_bad, encode_cols, encode_kv,
                                       encode_kv_tile, fold1, fold2, foldprod,
                                       kv_block_threshold, verify_and_correct,
                                       traditional_encode_cols,
                                       traditional_encode_rows,
                                       traditional_verify_correct,
                                       verify_block, verify_product,
                                       verify_product_log)
from repro_torch.core.efta import (MASK_VALUE, EFTAConfig, FTReport,
                                   efta_attention, efta_mha,
                                   reference_attention)
from repro_torch.core.decoupled import (decoupled_ft_attention,
                                        decoupled_memory_bytes)
from repro_torch.core.abft_gemm import abft_matmul, tensor_abft_matmul
from repro_torch.core.fault import (FaultSpec, Site, flip_bit_at, inject,
                                    random_fault)
from repro_torch.core.campaign import (DEFAULT_SITES, CampaignResult,
                                       KVCampaignResult, SiteTally,
                                       run_campaign, run_kv_campaign)
