from repro_torch.data.synthetic import (
    bigram_table,
    classif_batch_fn,
    classif_eval_set,
    lm_batch_fn,
    lm_eval_set,
    make_teacher,
    sample_lm,
    uniform_batch_fn,
)
