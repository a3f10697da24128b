from repro_torch.optim.adamw import AdamW, AdamWState, warmup_cosine
