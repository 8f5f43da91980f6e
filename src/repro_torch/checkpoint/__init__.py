from repro_torch.checkpoint.ckpt import (latest_step, load_checkpoint_flat,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_checkpoint_flat"]
