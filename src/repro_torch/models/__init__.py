from repro_torch.models.api import forward, get_model, init_params, loss_fn
