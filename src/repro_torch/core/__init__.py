from repro_torch.core.meta import (
    MetaState,
    init_state,
    make_meta_step,
    meta_step,
)
