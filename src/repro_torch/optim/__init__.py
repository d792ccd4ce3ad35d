from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                          apply_updates, cosine_schedule, sgd)
