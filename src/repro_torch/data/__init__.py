from repro_torch.data.pipeline import (DataConfig, SyntheticLM, as_tensors,
                                        make_pipeline)
