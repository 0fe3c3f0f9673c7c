"""Launchers (port of ``repro.launch``): the serving CLI,
``python -m repro_torch.launch.serve``, and the training CLI,
``python -m repro_torch.launch.train``.  Meshes and the multi-pod dry run
are not ported yet (ROADMAP.md, Queue 1 item 5)."""
