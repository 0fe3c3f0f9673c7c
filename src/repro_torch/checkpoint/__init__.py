from repro_torch.checkpoint.ckpt import (latest_step, load_flat, read_meta, restore,
                                        save, tuple_paths, unflatten)

__all__ = ["latest_step", "load_flat", "read_meta", "restore", "save", "tuple_paths",
           "unflatten"]
