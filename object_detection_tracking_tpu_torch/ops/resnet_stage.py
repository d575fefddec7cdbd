"""A stack of stride-1 bottleneck blocks, inference only: the plain PyTorch
spec and the CUDA kernel's wrapper (port of object_detection_tracking_tpu/
ops/pallas/resnet_stage_pallas.py).

Each block is 1x1 -> relu, 3x3 -> relu, 1x1, frozen BN folded into the
conv weights with float32 biases; the first block may carry a 1x1 shortcut
conv; each block ends with the residual add and a relu. Sums are float32
and the results round to the activation dtype exactly where the Pallas
kernel rounds them (resnet_stage_pallas.py:173, :233-245):

    l1  = relu(x . W1 + b1).to(dt)        l2 = relu(conv3x3(l1) + b2).to(dt)
    l3  = (l2 . W3 + b3).to(dt)           sc = (x . Wsc + bsc).to(dt) or x
    out = relu(l3 + sc)                   (in dt)

The 3x3 sees zero padding at the image edges. The Pallas kernel's chunks
of at most 3 blocks and its 128-lane padding of C_in = 64 are TPU VMEM
limits; here a stack of any length runs in one call.

Layouts follow the JAX package: x [B, H, W, C_in] NHWC, output
[B, H, W, c_out] in x's dtype. ``prepare_stage_weights`` gives the conv
weights as [K, N] matrices, K = C_in for a 1x1 and 9 * C_in for the 3x3 in
(dy, dx, c) order: the values of the JAX ``prepare_stage_weights``, the
layout the plain version and the kernel's f32 path read. The bf16 path
reads the same matrices transposed once, K-major [N, K].
"""

from __future__ import annotations

import ctypes
import weakref
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .norm import BN_EPS


def fold_bn(conv, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv's frozen BN folded into its weight: (W * scale) in ``dtype``,
    OIHW, and the float32 offset (JAX resnet_stage_pallas.py:55-62)."""
    bn = conv.bn
    scale = bn.gamma / torch.sqrt(bn.variance + BN_EPS)
    offset = bn.beta - bn.mean * scale
    w = (conv.weight * scale[:, None, None, None]).to(dtype)
    return w, offset.float()


def _matrix(w: torch.Tensor) -> torch.Tensor:
    """OIHW -> [kh * kw * I, O], rows in (dy, dx, c) order."""
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


@torch.no_grad()   # inference only: folded weights carry no graph
def prepare_stage_weights(blocks: Sequence, dtype: torch.dtype
                          ) -> Tuple[List[torch.Tensor], List[bool]]:
    """The kernel's arguments for a stride-1 bottleneck stack (port
    ``Bottleneck`` modules): per block w1, b1, w2, b2, w3, b3 and, on a
    block with a shortcut conv, wsc, bsc; weights [K, N] in ``dtype``,
    biases float32 [N] (JAX resnet_stage_pallas.py:65-90). Returns
    (args, has_shortcut per block)."""
    args: List[torch.Tensor] = []
    has_sc = []
    for blk in blocks:
        convs = [blk.conv1, blk.conv2, blk.conv3]
        if blk.convshortcut is not None:
            convs.append(blk.convshortcut)
        for conv in convs:
            w, b = fold_bn(conv, dtype)
            args += [_matrix(w), b]
        has_sc.append(blk.convshortcut is not None)
    return args, has_sc


# folded weights per stack, rebuilt when a weight changes (params_from_jax
# copies in place, .to() makes new tensors): first block -> {(n, dtype):
# (signature, args, has_sc)}
_FOLDED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _signature(blocks: Sequence) -> tuple:
    """Storage, device and version of every tensor the fold reads (each
    conv's weight and its BN's four), read directly: walking the modules'
    parameters and buffers costs ~4x as much, per call of the stage."""
    sig = []
    for blk in blocks:
        for conv in (blk.conv1, blk.conv2, blk.conv3, blk.convshortcut):
            if conv is None:
                continue
            bn = conv.bn
            for t in (conv.weight, bn.gamma, bn.beta, bn.mean, bn.variance):
                sig.append((t.data_ptr(), t.device,
                            -1 if t.is_inference() else t._version))
    return tuple(sig)


def _stage_weights(blocks: Sequence, dtype: torch.dtype, width: int,
                   c_out: int, k_major: bool = False):
    """(args, has_sc) of ``prepare_stage_weights``, cached. With
    ``k_major`` each weight matrix is the same fold transposed to [N, K]
    (K contiguous), the layout the bf16 kernel's TMA loads."""
    cache = _FOLDED.setdefault(blocks[0], {})
    key = (len(blocks), dtype, k_major)
    sig = _signature(blocks)
    hit = cache.get(key)
    if hit is not None and hit[0] == sig and -1 not in (s[2] for s in sig):
        return hit[1], hit[2]
    if k_major:
        args, has_sc = _stage_weights(blocks, dtype, width, c_out)
        args = [t.t().contiguous() if t.dim() == 2 else t for t in args]
        cache[key] = (sig, args, has_sc)
        return args, has_sc
    args, has_sc = prepare_stage_weights(blocks, dtype)
    if any(has_sc[1:]):
        raise ValueError("a shortcut conv is taken on the first block only")
    for blk in blocks[1 if has_sc[0] else 0:]:
        if blk.conv1.weight.shape[1] != c_out:
            raise ValueError("a block without a shortcut conv needs C_in "
                             "== c_out")
    for blk in blocks:
        if (blk.conv1.weight.shape[0] != width
                or blk.conv3.weight.shape[0] != c_out or blk.stride != 1
                or blk.dilation != 1 or blk.fc1 is not None
                or blk.conv2.groups != 1):
            raise ValueError("the stack takes plain stride-1 bottleneck "
                             f"blocks of width {width} and {c_out} outputs")
    cache[key] = (sig, args, has_sc)
    return args, has_sc


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, taps: int,
          acc: torch.dtype) -> torch.Tensor:
    """Conv of NHWC ``x`` by a [K, N] weight matrix, plus the bias, summed
    in ``acc``: a 1x1, or a 3x3 with zero padding 1."""
    xa = x.to(acc)
    if taps == 1:
        return torch.matmul(xa, w.to(acc)) + b.to(acc)
    c = x.shape[-1]
    wk = w.to(acc).reshape(3, 3, c, -1).permute(3, 2, 0, 1)
    y = F.conv2d(xa.permute(0, 3, 1, 2), wk, padding=1)
    return y.permute(0, 2, 3, 1) + b.to(acc)


def _stage_plain(args: Sequence[torch.Tensor], has_sc: Sequence[bool],
                 x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    dt = x.dtype
    cur = x
    i = 0
    for s in has_sc:
        w1, b1, w2, b2, w3, b3 = args[i:i + 6]
        i += 6
        l1 = torch.relu(_conv(cur, w1, b1, 1, acc)).to(dt)
        l2 = torch.relu(_conv(l1, w2, b2, 9, acc)).to(dt)
        l3 = _conv(l2, w3, b3, 1, acc).to(dt)
        if s:
            sc = _conv(cur, args[i], args[i + 1], 1, acc).to(dt)
            i += 2
        else:
            sc = cur
        cur = torch.relu(l3 + sc)
    return cur


def fused_bottleneck_stage(blocks: Sequence, x: torch.Tensor, width: int,
                           c_out: int, sum_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain PyTorch version of the stack — the kernel's spec and the CPU
    path. blocks: port ``Bottleneck`` modules (stride 1, a shortcut conv on
    the first only); x [B, H, W, C_in]. Returns [B, H, W, c_out] in
    x.dtype. ``sum_dtype`` float64 keeps the rounding points and changes
    only the sums: chip_smoke.py's yardstick of how far two bf16 runs of
    the same arithmetic drift apart."""
    args, has_sc = _stage_weights(blocks, x.dtype, width, c_out)
    return _stage_plain(args, has_sc, x, sum_dtype)


# --------------------------------------------------------------------------
# CUDA kernel wrapper (csrc/bottleneck_stage.cu)


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [ctypes.POINTER(ctypes.c_void_p)] + [_I] * 9 + [_P]


def _cuda_lib():
    from ..native import load_cuda
    fn = load_cuda("bottleneck_stage").bottleneck_stage_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fused_bottleneck_stage_cuda(blocks: Sequence, x: torch.Tensor,
                                width: int, c_out: int) -> torch.Tensor:
    """The stack through the hand-written CUDA kernel; same arguments and
    result as ``fused_bottleneck_stage``. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream (no
    sync) or raises. ``fused_bottleneck_stage_cuda.launches`` counts the
    calls that launched it (one per stack)."""
    if x.device.type == "cpu":
        return fused_bottleneck_stage(blocks, x, width, c_out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32/bfloat16 NHWC "
                         "[B, H, W, C] tensor")
    b, h, w, c_in = x.shape
    if c_in % 8 or width % 8 or c_out % 8:
        raise ValueError("channel counts must be multiples of 8 (16-byte "
                         f"rows): C_in {c_in}, width {width}, c_out {c_out}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    args, has_sc = _stage_weights(blocks, x.dtype, width, c_out,
                                  k_major=x.dtype == torch.bfloat16)
    if not has_sc[0] and c_in != c_out:
        raise ValueError(f"C_in {c_in} != c_out {c_out} needs a shortcut "
                         "conv on the first block")
    for t in args:
        if t.device != x.device:
            raise ValueError("the blocks' weights must be on x's device")
    out = torch.empty((b, h, w, c_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    empty = torch.empty((0,), dtype=x.dtype, device=x.device)
    l1 = torch.empty((b, h, w, width), dtype=x.dtype, device=x.device)
    l2 = torch.empty_like(l1)
    sc = torch.empty_like(out) if has_sc[0] else empty
    tmp = torch.empty_like(out) if len(has_sc) > 1 else empty
    ptrs = (ctypes.c_void_p * len(args))(*[t.data_ptr() for t in args])
    with torch.cuda.device(x.device):   # the runtime's launch device
        err = _cuda_lib()(
            x.data_ptr(), out.data_ptr(), l1.data_ptr(), l2.data_ptr(),
            sc.data_ptr(), tmp.data_ptr(), ptrs, len(has_sc),
            int(has_sc[0]), b, h, w, c_in, width, c_out,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"bottleneck_stage kernel launch failed: CUDA error {err}")
    fused_bottleneck_stage_cuda.launches += 1
    return out


fused_bottleneck_stage_cuda.launches = 0
