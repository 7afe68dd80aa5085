from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.loop import (TrainState, make_train_step,
                                    train_state_init)

__all__ = ["TrainState", "make_train_step", "train_state_init",
           "latest_step", "restore_checkpoint", "save_checkpoint"]
