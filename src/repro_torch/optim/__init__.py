from repro_torch.optim.optimizer import (AdamW, AdamWState, constant_lr,
                                         global_norm, warmup_cosine,
                                         warmup_stable_decay)

__all__ = ["AdamW", "AdamWState", "constant_lr", "global_norm",
           "warmup_cosine", "warmup_stable_decay"]
