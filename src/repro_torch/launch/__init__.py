"""Launchers (port of ``repro.launch``): the serving CLI,
``python -m repro_torch.launch.serve``.  Meshes, the multi-pod dry run and
training are not ported yet (ROADMAP.md, Queue 1 items 5 and 6)."""
