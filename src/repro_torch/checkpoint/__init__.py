from .ckpt import latest_step, restore, save
