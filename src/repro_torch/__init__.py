"""PyTorch / CUDA port of the ReCalKV serving path.

The package mirrors ``repro``'s layout (``models``, ``kernels``,
``serving``, ``configs``, ``api``, ``checkpoint``) so that every module
has an obvious counterpart.  It imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with the default device and no GPU they raise (see :mod:`.device`).
The attention hot spots run hand-written Hopper kernels
(``csrc/*.cu``, built at first use into ``build/kernels``); a tensor that
lies on the CPU takes each kernel's plain PyTorch version instead.
"""
