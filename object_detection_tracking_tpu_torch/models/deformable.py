"""Deformable convolution (port of object_detection_tracking_tpu/models/
deformable.py:24-84; reference deformable_helper.py + nn.py:1642-1712).

An offset conv predicts a (dy, dx) displacement per tap at the output
resolution; the main kxk conv then takes each tap bilinearly at its
displaced position. Coordinates are clamped to the image, as the JAX
``_bilinear_sample`` and the reference's ``_tf_batch_map_coordinates`` do
(not ``grid_sample``'s zero padding), so with all-zero offsets this equals
a SAME conv on the interior and replicates the border on the edge. The
taps of an output pixel are contracted with ``W`` as one
``[.., k*k*C] @ [k*k*C, C_out]`` product, as in JAX.

Plain PyTorch: JAX computes this outside any Pallas kernel. The four
corner gathers are ``index_select`` over the flat NHWC map (one index a
tap, not one a value). The sample coordinates are float32: JAX adds the
offsets to the integer grid in the offsets' dtype, which in bfloat16
leaves a coordinate of 136 a step of 1 pixel; in float32 the two agree.
"""

from __future__ import annotations

import torch

from .layers import Conv, conv2d


def deformable_conv2d(offset: Conv, weight: torch.Tensor, x: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W] -> [B, C_out, H', W'] (H' = ceil(H / stride)), SAME
    geometry; ``offset`` the offset conv (2*k*k outputs, tap-major, y then
    x), ``weight`` the main conv's [C_out, C, k, k]."""
    b, c, h, w = x.shape
    k = weight.shape[-1]
    pad = k // 2
    # [B, 2*k2, H', W'] -> [B, H', W', k2, 2]
    off = conv2d(offset, x, stride=stride, padding=((pad, pad), (pad, pad)))
    ho, wo = off.shape[2:]
    k2 = k * k
    off = off.float().permute(0, 2, 3, 1).reshape(b, ho, wo, k2, 2)
    dev = x.device
    tap = torch.arange(k, device=dev, dtype=torch.float32) - pad
    ky, kx = torch.meshgrid(tap, tap, indexing="ij")
    oy = torch.arange(ho, device=dev, dtype=torch.float32) * stride
    ox = torch.arange(wo, device=dev, dtype=torch.float32) * stride
    iy = oy[:, None, None] + ky.reshape(-1)[None, None, :] + off[..., 0]
    ix = ox[None, :, None] + kx.reshape(-1)[None, None, :] + off[..., 1]
    iy = iy.clamp(0.0, h - 1)
    ix = ix.clamp(0.0, w - 1)
    y0f, x0f = torch.floor(iy), torch.floor(ix)
    fy = (iy - y0f)[..., None].to(x.dtype)
    fx = (ix - x0f)[..., None].to(x.dtype)
    y0, x0 = y0f.long(), x0f.long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    flat = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    base = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1)

    def g(yy, xx):
        idx = (base + yy * w + xx).reshape(-1)
        return flat.index_select(0, idx).reshape(b, ho, wo, k2, c)

    top = g(y0, x0) * (1 - fx) + g(y0, x1) * fx
    bot = g(y1, x0) * (1 - fx) + g(y1, x1) * fx
    sampled = top * (1 - fy) + bot * fy                 # [B, H', W', k2, C]
    # [C_out, C, k, k] -> [k, k, C, C_out] -> [k2*C, C_out], tap-major
    wmat = weight.permute(2, 3, 1, 0).reshape(k2 * c, -1).to(x.dtype)
    out = sampled.reshape(b, ho, wo, k2 * c) @ wmat
    return out.permute(0, 3, 1, 2)
