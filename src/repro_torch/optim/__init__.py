from repro_torch.optim.optimizers import (adamw_init, adamw_lowmem_init,
                                          adamw_lowmem_update, adamw_update,
                                          apply_error_feedback,
                                          compress_grads,
                                          rowwise_adagrad_init,
                                          rowwise_adagrad_update, sgdm_init,
                                          sgdm_update)

__all__ = ["adamw_init", "adamw_lowmem_init", "adamw_lowmem_update",
           "adamw_update", "apply_error_feedback", "compress_grads",
           "rowwise_adagrad_init", "rowwise_adagrad_update", "sgdm_init",
           "sgdm_update"]
