from repro_torch.checkpoint.npz import (
    CheckpointVerifyError,
    checkpoint_step,
    latest_checkpoint,
    latest_verified_checkpoint,
    load_packspec,
    load_state,
    prune_checkpoints,
    save_state,
    verified_checkpoints,
    verify_checkpoint,
)
