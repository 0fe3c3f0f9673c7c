"""Training runtime of the port (port of ``repro.runtime``): the train
step with microbatch accumulation, and the loop with checkpoint restart,
a per-step watchdog and a NaN guard, on one device or a mesh."""

from repro_torch.runtime.train_loop import (TrainConfig, gather_train_state,
                                            init_train_state, make_train_step,
                                            shard_train_state, train_loop)
from repro_torch.runtime.watchdog import Watchdog, WatchdogTimeout

__all__ = ["TrainConfig", "Watchdog", "WatchdogTimeout", "gather_train_state",
           "init_train_state", "make_train_step", "shard_train_state", "train_loop"]
