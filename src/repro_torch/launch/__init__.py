"""Launchers (port of ``repro.launch``): the serving CLI,
``python -m repro_torch.launch.serve``, and the training CLI,
``python -m repro_torch.launch.train`` (one card, or ``--mesh`` under
``torchrun``); the meshes (``launch.mesh``); and the per-rank memory
report that stands in for the JAX dry run,
``python -m repro_torch.launch.dryrun --all``."""
