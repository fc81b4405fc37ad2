from repro_torch.optim.schedules import constant, cosine, warmup_cosine
