from repro_torch.comm.reducer import (
    DenseReducer,
    Reducer,
    dense_bytes,
    make_reducer,
)
