from repro_torch.data.synthetic import (
    bigram_table,
    lm_batch_fn,
    lm_eval_set,
    sample_lm,
    uniform_batch_fn,
)
