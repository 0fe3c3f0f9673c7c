"""Launchers (port of ``repro.launch``): the serving CLI,
``python -m repro_torch.launch.serve`` (one card, or ``--mesh`` under
``torchrun``), the training CLI, ``python -m repro_torch.launch.train``
(one card), and the serving meshes (``launch.mesh``).  Training on a mesh
and what stands in for the multi-pod dry run are ROADMAP.md Queue 1 item
5a."""
