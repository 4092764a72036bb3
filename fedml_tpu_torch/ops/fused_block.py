"""Fused BasicBlock epilogue: ``relu(y * scale + shift [+ residual])``.

The port of ``fedml_tpu/ops/pallas/fused_block.py``.  Four hand-written CUDA
kernels (``csrc/fused_block.cu``; its header note names the TPU kernels they
replace, their bound and their design) apply the BN affine folded by
``models/resnet._bn_scale_shift``, the shortcut add and the ReLU in one pass
over an NHWC activation, and compute the backward in one launch: in both
directions 16-byte vector loads where the shape and pointers allow, a
channel group a thread and one resident wave of blocks
(:func:`fwd_geometry` / :func:`bwd_geometry` choose), and in the backward
a fixed-order cross-block fold of ``d_scale`` / ``d_shift``.
``torch.autograd.Function`` wrappers save ``(y, scale, out)``: the ReLU mask
is recovered as ``out > 0``.

Lanes: given ``(L, C)`` scale and shift, every function here takes ``L``
lane-major activations ``(L, N, H, W, C)`` (the simulator's batched round:
one lane a client, each with its own BN statistics) and launches the same
kernels once for all lanes, each lane bitwise the single-lane launch on its
slice.  Those launches count under kernels of their own (``*_lanes``,
:data:`LANE_KERNELS`).

Beside the kernels, their plain PyTorch versions:
:func:`fused_block_reference` (mirrors the JAX reference at L289) and
:func:`fused_block_bwd_reference`.  A wrapper takes them only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises.  Each kernel
counts its launches on the card (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from . import build
from .build import aligned16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_fwd": (_I, [_P, _P, _P, _P, _P, _P, _P]),
    "fused_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]),
    "fused_fwd_lanes": (_I, [_P, _I, _P, _P, _P, _P, _P, _P]),
    "fused_bwd_lanes": (_I, [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]),
    "fused_blocks_per_sm": (_I, [_I, _I, _I, _I, ctypes.POINTER(_I)]),
    "fused_capture_id": (_I, [_P, ctypes.POINTER(ctypes.c_ulonglong)]),
}
# the kernels' block size and the backward's ticket slots: kThreads and
# kTicketSlots in the .cu source
THREADS = 256
TICKET_SLOTS = 65536
MAX_LANES = 65535  # the grid's z extent
# most partials (row_blocks * 2 * C floats) the last block folds: 32 KB,
# at most kFoldBatch 16-byte loads a thread, issued together
FOLD_FLOATS = 8192

FWD = build.Kernel("fused_bn_relu_fwd", "fedml_tpu/ops/pallas/fused_block.py:91")
FWD_RES = build.Kernel("fused_bn_residual_relu_fwd", "fedml_tpu/ops/pallas/fused_block.py:85")
BWD = build.Kernel("fused_bn_relu_bwd", "fedml_tpu/ops/pallas/fused_block.py:142")
BWD_RES = build.Kernel("fused_bn_residual_relu_bwd", "fedml_tpu/ops/pallas/fused_block.py:126")
KERNELS = (FWD, FWD_RES, BWD, BWD_RES)
# the same kernels launched once for L lanes (fused_fwd_lanes / fused_bwd_lanes)
FWD_LANES = build.Kernel("fused_bn_relu_fwd_lanes", FWD.replaces)
FWD_RES_LANES = build.Kernel("fused_bn_residual_relu_fwd_lanes", FWD_RES.replaces)
BWD_LANES = build.Kernel("fused_bn_relu_bwd_lanes", BWD.replaces)
BWD_RES_LANES = build.Kernel("fused_bn_residual_relu_bwd_lanes", BWD_RES.replaces)
LANE_KERNELS = (FWD_LANES, FWD_RES_LANES, BWD_LANES, BWD_RES_LANES)
SOURCE = "fedml_tpu_torch/csrc/fused_block.cu"


# the variants a launch counts under: the backward's "vector" (16-byte
# loads) or "scalar", the forward's "fwd_vector" or "fwd_scalar"
VARIANTS = ("vector", "scalar", "fwd_vector", "fwd_scalar")


def launch_counts() -> dict:
    """Launches on the card by kernel since the last reset, the lane-batched
    ones (``*_lanes``) apart."""
    return {k.name: k.launches for k in KERNELS + LANE_KERNELS}


def variant_counts() -> dict:
    """Launches on the card by variant, since the last reset, lanes or not:
    the backward's under ``"vector"`` / ``"scalar"``, the forward's under
    ``"fwd_vector"`` / ``"fwd_scalar"``."""
    counts = dict.fromkeys(VARIANTS, 0)
    for k in KERNELS + LANE_KERNELS:
        for variant, n in k.variant_counts().items():
            counts[variant] += n
    return counts


def reset_launch_counts() -> None:
    for k in KERNELS + LANE_KERNELS:
        k.reset()


def _lib():
    return build.load_library("fused_block", _SIGNATURES)


# -- plain PyTorch versions (the CPU path and the kernels' oracle) -----------

def _per_channel(v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A per-channel vector as it broadcasts over ``y``: ``(C,)`` as it is,
    a lane's ``(L, C)`` as ``(L, 1, ..., 1, C)``."""
    if v.ndim == 1:
        return v
    return v.reshape(v.shape[:1] + (1,) * (y.ndim - 2) + v.shape[1:])


def fused_block_reference(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per lane when scale and shift are ``(L, C)``."""
    z = (y.to(torch.float32) * _per_channel(scale.to(torch.float32), y)
         + _per_channel(shift.to(torch.float32), y))
    if residual is not None:
        z = z + residual.to(torch.float32)
    return torch.relu(z).to(y.dtype)


def fused_block_bwd_reference(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                              out: torch.Tensor, with_residual: bool):
    """``(dy, d_scale, d_shift, dr)`` with the kernel's explicit mask
    ``out > 0`` (never autograd through a max, which splits at a tie); per
    lane (sums over each lane's pixels) when scale is ``(L, C)``."""
    gm = g.to(torch.float32) * (out > 0).to(torch.float32)
    dy = (gm * _per_channel(scale.to(torch.float32), y)).to(y.dtype)
    axes = tuple(range(scale.ndim - 1, gm.ndim - 1))
    d_scale = (gm * y.to(torch.float32)).sum(axes)
    d_shift = gm.sum(axes)
    dr = gm.to(y.dtype) if with_residual else None
    return dy, d_scale, d_shift, dr


# -- kernel launches ---------------------------------------------------------

def _check(y: torch.Tensor, vectors, others) -> int:
    """Checks the operands; returns the lanes (0 for the single-lane form:
    NHWC ``y``, ``(C,)`` vectors; ``L`` for ``(L, N, H, W, C)`` and ``(L,
    C)``)."""
    if y.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused block kernel takes float32 or bfloat16, got {y.dtype}")
    lanes = y.shape[0] if vectors[0].ndim == 2 else 0
    if y.ndim != (5 if lanes else 4) or not y.is_contiguous():
        raise ValueError(f"fused block kernel takes a contiguous {'lane-major ' if lanes else ''}"
                         f"NHWC tensor, got shape {tuple(y.shape)} with strides {y.stride()}")
    lane_numel = y.numel() // max(lanes, 1)
    if lane_numel == 0 or lane_numel >= 2**31 or lanes > MAX_LANES:
        raise ValueError(f"fused block kernel takes 1 <= numel < 2**31 a lane and at most "
                         f"{MAX_LANES} lanes, got {tuple(y.shape)}")
    c = y.shape[-1]
    want = (lanes, c) if lanes else (c,)
    for v in vectors:
        if v.device != y.device:
            raise ValueError(f"operands on {v.device} and {y.device}")
        if v.dtype != torch.float32 or v.shape != want or not v.is_contiguous():
            raise ValueError(f"per-channel vector must be contiguous float32 {want}, "
                             f"got {v.dtype} {tuple(v.shape)}")
    for t in others:
        if t is None:
            continue
        if t.dtype != y.dtype or t.shape != y.shape or not t.is_contiguous():
            raise ValueError("operand must match y's dtype/shape and be contiguous, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != y.device:
            raise ValueError(f"operands on {t.device} and {y.device}")
    return lanes


def _fwd_cuda(y, scale, shift, residual):
    lanes = _check(y, (scale, shift), (residual,))
    if lanes:
        kernel = FWD_RES_LANES if residual is not None else FWD_LANES
    else:
        kernel = FWD_RES if residual is not None else FWD
    device, c = y.device, y.shape[-1]
    stream = build.current_stream(device, "fused block kernel")
    out = torch.empty_like(y)
    # a null residual pointer (0) is aligned
    ptrs = (y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            residual.data_ptr() if residual is not None else 0, out.data_ptr())
    # the geometry of one lane: each lane offsets within the launch
    geo, geo_args = _launch_geometry(False, device.index, y.dtype, y.numel() // c // max(lanes, 1),
                                     c, aligned16(ptrs), residual is not None)
    if lanes:
        err = _lib().fused_fwd_lanes(geo_args, lanes, *ptrs, stream)
    else:
        err = _lib().fused_fwd(geo_args, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.count_launch("fwd_vector" if geo.vec > 1 else "fwd_scalar")
    return out


class Geometry(NamedTuple):
    """How a kernel covers a ``(rows, c)`` activation: ``vec`` channels a
    thread (16-byte loads when > 1), ``cg`` channel groups of ``vec`` and
    ``rb`` rows side by side in a block of ``cg * rb`` threads, a grid of
    ``row_blocks`` x ``channel_blocks`` blocks, block ``(bx, by)`` taking
    rows ``[bx * rows_per_block, ...)`` and channel groups ``[by * cg,
    ...)``."""

    rows: int
    c: int
    vec: int
    cg: int
    rb: int
    row_blocks: int
    channel_blocks: int
    rows_per_block: int

    @property
    def scratch_floats(self) -> int:
        """Scratch of a launch: a row of ``2 * c`` partials per row block."""
        return self.row_blocks * 2 * self.c


def vector_width(c: int, itemsize: int, aligned: bool) -> int:
    """Channels a thread of either kernel takes: those in 16 bytes (8 bf16,
    4 f32) when ``c`` is a multiple of that and every operand is 16-byte
    aligned (the vector variant), else 1 (the scalar variant)."""
    vec = 16 // itemsize
    return vec if c % vec == 0 and aligned else 1


def _geometry(rows: int, c: int, itemsize: int, aligned: bool, sm_count: int,
              blocks_per_sm: int, max_partials: Optional[int]) -> Geometry:
    """One resident wave of row blocks on a card of ``sm_count`` SMs that
    hold ``blocks_per_sm`` blocks each, capped by the rows (a row a thread
    at least) and, when ``max_partials`` is given, by ``row_blocks * 2 * c
    <= max_partials``."""
    vec = vector_width(c, itemsize, aligned)
    groups = c // vec
    cg = min(groups, THREADS)
    rb = THREADS // cg
    channel_blocks = -(-groups // cg)
    wave = max(1, sm_count * blocks_per_sm // channel_blocks)
    row_blocks = min(-(-rows // rb), wave)
    if max_partials is not None:
        row_blocks = min(row_blocks, max_partials // (2 * c))
    rows_per_block = -(-rows // max(1, row_blocks))
    row_blocks = -(-rows // rows_per_block)  # no block without rows
    return Geometry(rows, c, vec, cg, rb, row_blocks, channel_blocks, rows_per_block)


def fwd_geometry(rows: int, c: int, itemsize: int, aligned: bool, sm_count: int,
                 blocks_per_sm: int) -> Geometry:
    """The forward's geometry: one resident wave of row blocks, capped by
    the rows."""
    return _geometry(rows, c, itemsize, aligned, sm_count, blocks_per_sm, None)


def bwd_geometry(rows: int, c: int, itemsize: int, aligned: bool, sm_count: int,
                 blocks_per_sm: int) -> Geometry:
    """The backward's geometry: the forward's, also capped by the partials
    the last block folds (:data:`FOLD_FLOATS`)."""
    return _geometry(rows, c, itemsize, aligned, sm_count, blocks_per_sm, FOLD_FLOATS)


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(device_index: int, backward: bool, dtype_code: int, vec: int,
                   residual: bool) -> int:
    """Resident blocks per SM of one kernel instance (the occupancy API),
    once per device and instance.  The current device is ``device_index``."""
    blocks = _I(0)
    err = _lib().fused_blocks_per_sm(int(backward), dtype_code, vec, int(residual),
                                     ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"fused block kernel: occupancy query failed with error {err}")
    return blocks.value


@functools.lru_cache(maxsize=512)
def _launch_geometry(backward: bool, device_index: int, dtype: torch.dtype, rows: int, c: int,
                     aligned: bool, residual: bool):
    """``(geometry, the int array the C entry takes)``, once per direction
    and shape."""
    code = _DTYPE_CODES[dtype]
    occupancy = _blocks_per_sm(device_index, backward, code,
                               vector_width(c, dtype.itemsize, aligned), residual)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    geo = (bwd_geometry if backward else fwd_geometry)(rows, c, dtype.itemsize, aligned, sms,
                                                       occupancy)
    return geo, (_I * 9)(code, *geo)


# Workspace of the backward: a ticket slot per (device index, owner) and
# scratch rows per (device index, stream).  The owner of an eager call is
# its stream; that of a call captured into a CUDA graph is ("capture", the
# capture's id, the capturing stream).  Kernels on one stream run in order,
# and so do the calls one stream captured, in the graph, so an owner's slot
# is never used by two launches at once (the cross-silo clients' threads
# share the default stream; tests run threads on streams of their own), while
# two graphs, or a graph and eager calls, running at once never share one.
# Built under a lock, like build.load_library.
_SLOTS: dict = {}  # (device index, owner) -> ticket slot
_NEXT_SLOT: dict = {}  # device index -> first unused slot
_SCRATCH: dict = {}  # (device index, stream) -> float32 scratch
_WORKSPACE_LOCK = threading.Lock()


def _ticket_slot(device_index: int, owner, lanes: int = 1) -> int:
    """The first of ``owner``'s consecutive ticket slots on the device (a
    stream, or a capture's key; one a lane), assigned at its first launch
    and again, further on, at its first launch of more lanes than it holds
    (its launches run in order, so its old slots are never in use then)."""
    key = (device_index, owner)
    held = _SLOTS.get(key)
    if held is None or held[1] < lanes:
        with _WORKSPACE_LOCK:
            held = _SLOTS.get(key)
            if held is None or held[1] < lanes:
                slot = _NEXT_SLOT.get(device_index, 0)
                if slot + lanes > TICKET_SLOTS:
                    raise RuntimeError(
                        f"fused block backward: all {TICKET_SLOTS} ticket slots of device "
                        f"{device_index} are taken (one per stream and per stream of each "
                        "capture into a CUDA graph, one a lane)")
                _NEXT_SLOT[device_index] = slot + lanes
                held = _SLOTS[key] = (slot, lanes)
    return held[0]


def _capture_id(stream: int) -> int:
    """The id of the capture ``stream`` is recording into a CUDA graph."""
    capture = ctypes.c_ulonglong(0)
    err = _lib().fused_capture_id(stream, ctypes.byref(capture))
    if err != 0:
        raise RuntimeError(f"fused block backward: capture query failed with error {err}")
    return capture.value


def _workspace(device: torch.device, stream: int, floats: int, lanes: int = 1):
    """``(first ticket slot, scratch)`` for a launch of ``lanes`` lanes on
    ``stream``.  A call captured into a CUDA graph gets the slots of its
    capture and stream, and scratch from the graph's pool; an eager call
    gets its stream's slots and scratch, grown when a launch needs more (the
    old buffer is freed in stream order)."""
    if torch.cuda.is_current_stream_capturing():
        return (_ticket_slot(device.index, ("capture", _capture_id(stream), stream), lanes),
                torch.empty(floats, dtype=torch.float32, device=device))
    slot = _ticket_slot(device.index, stream, lanes)
    key = (device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch.numel() < floats:
        with _WORKSPACE_LOCK:
            scratch = _SCRATCH.get(key)
            if scratch is None or scratch.numel() < floats:
                scratch = torch.empty(floats, dtype=torch.float32, device=device)
                _SCRATCH[key] = scratch
    return slot, scratch


def _bwd_cuda(g, y, scale, out, with_residual: bool):
    lanes = _check(y, (scale,), (g, out))
    if lanes:
        kernel = BWD_RES_LANES if with_residual else BWD_LANES
    else:
        kernel = BWD_RES if with_residual else BWD
    n_lanes = max(lanes, 1)
    c = y.shape[-1]
    stream = build.current_stream(y.device, "fused block kernel")
    ptrs = (g.data_ptr(), y.data_ptr(), scale.data_ptr(), out.data_ptr())
    geo, geo_args = _launch_geometry(True, y.device.index, y.dtype, y.numel() // c // n_lanes, c,
                                     aligned16(ptrs), with_residual)
    dy = torch.empty_like(y)
    dr = torch.empty_like(y) if with_residual else None
    dss = torch.empty((n_lanes, 2, c), dtype=torch.float32, device=y.device)
    slot, scratch = _workspace(y.device, stream, geo.scratch_floats * n_lanes, n_lanes)
    tail = (dy.data_ptr(), dr.data_ptr() if dr is not None else None, dss.data_ptr(),
            scratch.data_ptr(), slot, stream)
    if lanes:
        err = _lib().fused_bwd_lanes(geo_args, lanes, *ptrs, *tail)
    else:
        err = _lib().fused_bwd(geo_args, *ptrs, *tail)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.count_launch("vector" if geo.vec > 1 else "scalar")
    if lanes:
        return dy, dss[:, 0], dss[:, 1], dr
    return dy, dss[0, 0], dss[0, 1], dr


def fused_block_forward(y, scale, shift, residual=None):
    """One forward pass: the CUDA kernel on the card, the plain version on
    the CPU; any other device raises."""
    if y.is_cuda:
        return _fwd_cuda(y, scale, shift, residual)
    if y.device.type == "cpu":
        return fused_block_reference(y, scale, shift, residual)
    raise RuntimeError(f"fused block has no kernel for device {y.device}")


def fused_block_backward(g, y, scale, out, with_residual: bool):
    """One backward pass: ``(dy, d_scale, d_shift, dr)``, dispatched like
    :func:`fused_block_forward`."""
    if y.is_cuda:
        return _bwd_cuda(g if g.is_contiguous() else g.contiguous(), y, scale, out,
                         with_residual)
    if y.device.type == "cpu":
        return fused_block_bwd_reference(g, y, scale, out, with_residual)
    raise RuntimeError(f"fused block has no kernel for device {y.device}")


#: why a gradient of a gradient through the fused blocks is refused: the
#: reference's ``custom_vjp`` over ``pallas_call`` fails there (its
#: ``invert_gradient_attack`` through a fused ResNet-20, interpret mode on
#: the CPU), and this port keeps that decision rather than differentiate a
#: backward the reference never defined
SECOND_ORDER_REFUSAL = (
    "second-order differentiation through the fused blocks (a gradient of a gradient, as "
    "DLG and the gradient-inversion attack take) is not supported: the reference's "
    "custom_vjp over pallas_call fails the same way (ValueError: Linearization failed to "
    "produce known values for all output primals); build the model without fused_blocks "
    "for such attacks")


def _refuse_second_order() -> None:
    """Called from a fused backward: autograd records the backward's ops
    (``create_graph=True``) only when grad mode is on inside it."""
    if torch.is_grad_enabled():
        raise RuntimeError(SECOND_ORDER_REFUSAL)


class _FusedBNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift):
        out = fused_block_forward(y, scale, shift)
        ctx.save_for_backward(y, scale, out)
        return out

    @staticmethod
    def backward(ctx, g):
        _refuse_second_order()
        y, scale, out = ctx.saved_tensors
        dy, d_scale, d_shift, _ = fused_block_backward(g, y, scale, out, False)
        return dy, d_scale, d_shift


class _FusedBNResidualReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift, residual):
        out = fused_block_forward(y, scale, shift, residual)
        ctx.save_for_backward(y, scale, out)
        return out

    @staticmethod
    def backward(ctx, g):
        _refuse_second_order()
        y, scale, out = ctx.saved_tensors
        dy, d_scale, d_shift, dr = fused_block_backward(g, y, scale, out, True)
        return dy, d_scale, d_shift, dr


def fused_bn_relu(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``relu(y * scale + shift)`` with a per-channel (last-axis) affine, in
    one fused pass; differentiable (fused backward).  ``(L, C)`` scale and
    shift: per lane of a lane-major ``(L, N, H, W, C)`` y, one launch."""
    return _FusedBNReLU.apply(y, scale, shift)


def fused_bn_residual_relu(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                           residual: torch.Tensor) -> torch.Tensor:
    """``relu(y * scale + shift + residual)``: the whole BasicBlock epilogue
    (BN apply, shortcut add, activation) in one fused pass; differentiable;
    per lane like :func:`fused_bn_relu`."""
    return _FusedBNResidualReLU.apply(y, scale, shift, residual)
