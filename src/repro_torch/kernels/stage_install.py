"""The continuous-batching install's cache copy: a device-predicated row
copy — CUDA kernel, plain version, wrapper.

``stage_install_rows`` copies row ``q`` of each stage-cache leaf into row
``slot`` of the matching serving-cache leaf, where ``slot`` and ``q`` are
0-d int64 tensors on the device (the window iteration finds them there);
a ``slot`` outside ``[0, rows)`` copies nothing.  On a card the kernel
reads its leaves from an :class:`InstallTable`, which the owner of the
leaves builds once and holds as long as the leaves (and any CUDA graph
captured over them) live.  It is glue, not a TPU
kernel: the JAX package does the same with an XLA scatter in
``mode="drop"`` (``repro.models.transformer.swap_cache_slot``).  On a card
it runs ``csrc/stage_install.cu``, which reads the two indices on the
device and returns at once when nothing installs, so an idle iteration
does not move a row; on the CPU it runs the plain version, a
``torch.where`` over the selected row and an ``index_copy_`` at the slot.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.latent_decode import _on_device

_THREADS = 256
_GRID_PER_SM = 4


def stage_install_rows_plain(dst: list, src: list, slot: torch.Tensor,
                             q: torch.Tensor) -> None:
    """Plain version, in place: per leaf, the slot row becomes the staged
    row where ``slot`` is in range (``torch.where`` on the selected row),
    and is written back unchanged otherwise."""
    for d, s in zip(dst, src):
        B = d.shape[0]
        do = (slot >= 0) & (slot < B)
        at = slot.clamp(0, B - 1).reshape(1)
        row = torch.where(do, s.index_select(0, q.reshape(1)), d.index_select(0, at))
        d.index_copy_(0, at, row)


def _check(dst, src, slot, q):
    if not dst or len(dst) != len(src):
        raise ValueError(f"stage install takes matching leaf lists, got {len(dst)} "
                         f"destination and {len(src)} source leaves")
    n_rows, n_src = dst[0].shape[0], src[0].shape[0]
    for d, s in zip(dst, src):
        if d.dtype != s.dtype or tuple(d.shape[1:]) != tuple(s.shape[1:]):
            raise ValueError(f"stage install: leaf {tuple(d.shape)} {d.dtype} cannot take "
                             f"rows of {tuple(s.shape)} {s.dtype}")
        if d.shape[0] != n_rows or s.shape[0] != n_src:
            raise ValueError("stage install: every destination leaf needs the same rows, "
                             "and every source leaf")
        if not (d.is_contiguous() and s.is_contiguous()):
            raise ValueError("stage install: leaves must be contiguous")
        if d.device != slot.device or s.device != slot.device:
            raise ValueError(f"stage install: every leaf must be on {slot.device}")
    for name, t in (("slot", slot), ("q", q)):
        if t.dtype != torch.int64 or t.numel() != 1 or t.device != slot.device:
            raise TypeError(f"stage install: {name} must be one int64 on {slot.device}, "
                            f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return n_rows, n_src


def _layout(dst, src) -> tuple:
    """(dst address, src address, row bytes, dst rows, src rows) per leaf."""
    return tuple((d.data_ptr(), s.data_ptr(), d[0].numel() * d.element_size(),
                  d.shape[0], s.shape[0]) for d, s in zip(dst, src))


class InstallTable:
    """The device table (dst, src, row bytes) per leaf that the kernel
    reads, built from leaves that never move: a serving cache and its
    stage cache.  Its owner holds it beside them, so a captured graph that
    reads it by address never outlives it.  Built before any capture, it
    goes up from pinned memory without waiting: the overlapped engine must
    not stall the host behind the windows in flight.  ``layout`` keeps the
    leaves' addresses, row bytes and row counts on the host, so a call
    with other leaves is refused rather than copying by a stale table."""

    def __init__(self, dst: list, src: list):
        if not dst or not dst[0].is_cuda:
            raise ValueError("an install table is built over CUDA leaves")
        self.layout = _layout(dst, src)
        self.dev = torch.tensor([r[:3] for r in self.layout], dtype=torch.int64).pin_memory().to(
            dst[0].device, non_blocking=True)


def _lib():
    lib = build.load("stage_install")
    fn = lib.recalkv_stage_install
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def stage_install_rows(dst: list, src: list, slot: torch.Tensor, q: torch.Tensor,
                       table: InstallTable | None = None) -> None:
    """Copy row ``q`` of each ``src`` leaf into row ``slot`` of its ``dst``
    leaf, in place, unless ``slot`` is out of range.  A CPU tensor runs the
    plain version; a CUDA tensor runs the kernel (built at first use) over
    ``table``, which must have been built over these very leaves, or
    raises.  ``stage_install_rows.launches`` counts kernel launches."""
    if not _on_device("stage install", slot):
        stage_install_rows_plain(dst, src, slot, q)
        return
    n_rows, n_src = _check(dst, src, slot, q)
    if table is None:
        raise ValueError("stage install on a card needs the InstallTable its leaves' "
                         "owner built over them")
    if table.layout != _layout(dst, src):
        raise ValueError("stage install: the table was built over other leaves (addresses, "
                         "row bytes or row counts differ)")
    dev = slot.device
    tab = table.dev
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row_bytes = max(d[0].numel() * d.element_size() for d in dst)
    grid = max(1, min(_GRID_PER_SM * sms, -(-row_bytes // (_THREADS * 16))))
    err = _lib().recalkv_stage_install(
        tab.data_ptr(), len(dst), slot.data_ptr(), q.data_ptr(), n_rows, n_src, grid,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "recalkv_stage_install")
    stage_install_rows.launches += 1


stage_install_rows.launches = 0
