"""vision.ops — detection primitives (counterpart of
``paddle_tpu/vision/ops.py``; ref: python/paddle/vision/ops.py).

Plain torch ops, as the reference's are plain ``jnp``: none is a TPU kernel
of the repo. Where the reference brings a value to the host (a
data-dependent output size: ``nms``'s kept indices, proposals, per-box
loops over host boxes), the port does too, on the same arithmetic:

- ``nms`` computes every pair's IoU on the boxes' device (the reference's
  expression, ``inter / (area_i + area_j - inter + 1e-10)`` in f32) and
  sweeps the suppression mask on the host in score order, as the
  reference's per-box loop does (and the bitmask sweep of Paddle's CUDA
  kernel). Scores are ordered by a stable sort.
- ``roi_align`` / ``roi_pool`` sample each box's ``2·oh x 2·ow`` grid
  (``linspace`` over the box, clipped to the map) bilinearly or at the
  nearest pixel and reduce 2x2 cells, for all boxes at once on the
  device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

__all__ = ["nms", "box_area", "box_iou", "roi_align", "roi_pool"]


def _t(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(np.asarray(x), device=dev)


def _host(x, dtype=np.float32):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def box_area(boxes):
    """``[N, 4]`` xyxy -> ``[N]``."""
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def box_iou(boxes1, boxes2):
    """``[N, 4]`` x ``[M, 4]`` -> ``[N, M]`` IoU."""
    a, b = boxes1, boxes2
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


def _overlaps(b, iou_threshold):
    """``[N, N]`` bool: pair (i, j)'s IoU above the threshold, in the
    reference's f32 arithmetic, on ``b``'s device."""
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    xx1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    yy1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    xx2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    yy2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = torch.clamp(xx2 - xx1, min=0) * torch.clamp(yy2 - yy1, min=0)
    iou = inter / (areas[:, None] + areas[None, :] - inter + 1e-10)
    return iou > iou_threshold


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None):
    """Greedy NMS (ref: ops.py nms; categories kept apart by offsetting
    each category's boxes past the whole coordinate span). Returns the kept
    indices (int64, on the boxes' device) by descending score. Host-synced:
    the output's size depends on the data."""
    b = _t(boxes).to(torch.float32)
    dev = b.device
    n = b.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    if scores is None:
        s = torch.arange(n, 0, -1, dtype=torch.float32, device=dev)
    else:
        s = _t(scores, b).to(device=dev, dtype=torch.float32)
    if category_idxs is not None:
        cats = _t(category_idxs, b).to(dev)
        stride = b.max() - torch.clamp(b.min(), max=0.0) + 1.0
        b = b + (stride * cats.to(torch.float32))[:, None]
    order = torch.sort(-s, stable=True).indices.cpu().numpy()
    over = _overlaps(b, iou_threshold).cpu().numpy()
    keep, suppressed = [], np.zeros(n, bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed |= over[i]
    if top_k is not None:
        keep = keep[:top_k]
    return torch.as_tensor(keep, dtype=torch.int64, device=dev)


def _linspace(start, stop, num):
    """``jnp.linspace(start, stop, num)`` for a column of starts and stops
    (``[K]`` each) -> ``[K, num]``."""
    step = torch.arange(num, dtype=start.dtype, device=start.device)
    frac = step / max(num - 1, 1)
    out = start[:, None] + (stop - start)[:, None] * frac[None, :]
    if num > 1:
        out[:, -1] = stop
    return out


def _roi_pool_common(x, boxes, boxes_num, output_size, spatial_scale, mode):
    """Crop-and-resize of every box: a ``(2·oh, 2·ow)`` grid sampled from
    its image (bilinear for ``"align"``, the nearest pixel for ``"pool"``),
    then 2x2 cells averaged (align) or maxed (pool)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    bx = _t(boxes, x).to(device=x.device, dtype=torch.float32) * spatial_scale
    counts = _t(boxes_num, x).to(device=x.device, dtype=torch.int64)
    img = torch.repeat_interleave(
        torch.arange(counts.numel(), device=x.device), counts)
    k = bx.shape[0]
    if k == 0:
        return x.new_zeros((0, c, oh, ow))
    gy = torch.clamp(_linspace(bx[:, 1], bx[:, 3], 2 * oh), 0, h - 1)
    gx = torch.clamp(_linspace(bx[:, 0], bx[:, 2], 2 * ow), 0, w - 1)
    b = img[:, None, None]

    def at(yi, xi):  # [K, 2oh, 2ow, C]
        return x[b, :, yi[:, :, None], xi[:, None, :]]

    if mode == "align":
        y0 = torch.floor(gy).long()
        x0 = torch.floor(gx).long()
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (gy - y0).to(x.dtype)[:, :, None, None]
        wx = (gx - x0).to(x.dtype)[:, None, :, None]
        grid = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
                + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
        grid = grid.permute(0, 3, 1, 2).reshape(k, c, oh, 2, ow, 2)
        return grid.mean(dim=(3, 5))
    grid = at(torch.round(gy).long(), torch.round(gx).long())
    grid = grid.permute(0, 3, 1, 2).reshape(k, c, oh, 2, ow, 2)
    return grid.amax(dim=(3, 5))


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """ref: ops.py roi_align (``sampling_ratio`` and ``aligned`` are taken
    and, as in the reference, not used)."""
    return _roi_pool_common(x, boxes, boxes_num, output_size, spatial_scale,
                            "align")


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """ref: ops.py roi_pool."""
    return _roi_pool_common(x, boxes, boxes_num, output_size, spatial_scale,
                            "pool")


class RoIPool(nn.Module):
    """ref: ops.py RoIPool."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class RoIAlign(nn.Module):
    """ref: ops.py RoIAlign."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (ref: ops.py psroi_pool): input
    channels C = out_channels · oh · ow; output bin (i, j) averages its own
    channel group over the bin's pixels (bounds from the host boxes)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    n, c, h, w = x.shape
    if c % (oh * ow) != 0:
        raise ValueError(f"psroi_pool: channels {c} must divide {oh}x{ow}")
    oc = c // (oh * ow)
    ba = _host(boxes)
    bn = _host(boxes_num, np.int64)
    img_idx = np.repeat(np.arange(len(bn)), bn)
    outs = []
    for k, box in enumerate(ba):
        x1, y1, x2, y2 = box * np.float32(spatial_scale)
        img = x[int(img_idx[k])].reshape(oc, oh, ow, h, w)
        bh = max((y2 - y1) / oh, 1e-6)
        bw = max((x2 - x1) / ow, 1e-6)
        bins = []
        for i in range(oh):
            row = []
            for j in range(ow):
                ys = int(np.clip(np.floor(y1 + i * bh), 0, h - 1))
                ye = int(np.clip(np.ceil(y1 + (i + 1) * bh), ys + 1, h))
                xs = int(np.clip(np.floor(x1 + j * bw), 0, w - 1))
                xe = int(np.clip(np.ceil(x1 + (j + 1) * bw), xs + 1, w))
                row.append(img[:, i, j, ys:ye, xs:xe].mean(dim=(1, 2)))
            bins.append(torch.stack(row, -1))
        outs.append(torch.stack(bins, -2))
    return torch.stack(outs)


class PSRoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 / v2 (ref: ops.py deform_conv2d): the
    input sampled bilinearly at each kernel tap's offset position (zero
    outside the map), optionally scaled by ``mask``, then contracted with
    the grouped weight."""
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    n, c, h, w = x.shape
    co, _, kh, kw = weight.shape
    dg = deformable_groups
    oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    dev, dt = x.device, x.dtype
    oy = torch.arange(oh, device=dev) * s[0] - p[0]
    ox = torch.arange(ow, device=dev) * s[1] - p[1]
    ky = torch.arange(kh, device=dev) * d[0]
    kx = torch.arange(kw, device=dev) * d[1]
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).to(dt)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).to(dt)
    off = offset.reshape(n, dg, kh, kw, 2, oh, ow)
    # [n, dg, oh, ow, kh, kw]
    dy = off[:, :, :, :, 0].permute(0, 1, 4, 5, 2, 3)
    dx = off[:, :, :, :, 1].permute(0, 1, 4, 5, 2, 3)
    sy = base_y[None, None] + dy
    sx = base_x[None, None] + dx
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    cg = c // dg
    xg = x.reshape(n, dg, cg, h, w)
    ni = torch.arange(n, device=dev)[:, None, None, None, None, None]
    gi = torch.arange(dg, device=dev)[None, :, None, None, None, None]

    def gather(yy, xx):  # [n, dg, oh, ow, kh, kw, cg]
        yi = torch.clamp(yy.long(), 0, h - 1)
        xi = torch.clamp(xx.long(), 0, w - 1)
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        vals = xg[ni, gi, :, yi, xi]
        return torch.where(inb[..., None], vals, torch.zeros((), dtype=dt,
                                                              device=dev))

    sampled = (gather(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
               + gather(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
               + gather(y0 + 1, x0) * (wy * (1 - wx))[..., None]
               + gather(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    if mask is not None:
        m = mask.reshape(n, dg, kh, kw, oh, ow).permute(0, 1, 4, 5, 2, 3)
        sampled = sampled * m[..., None]
    # [n, dg, oh, ow, kh, kw, cg] -> [n, oh, ow, c, kh, kw]
    samp = sampled.permute(0, 2, 3, 1, 6, 4, 5).reshape(n, oh, ow, c, kh, kw)
    cg2 = c // groups
    samp_g = samp.reshape(n, oh, ow, groups, cg2, kh, kw)
    wt_g = weight.reshape(groups, co // groups, cg2, kh, kw)
    out = torch.einsum("nhwgckl,gockl->ngohw", samp_g, wt_g)
    out = out.reshape(n, co, oh, ow)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


class DeformConv2D(nn.Module):
    """ref: ops.py DeformConv2D: weight ``[out, in / groups, kh, kw]``
    (the reference's default weight init, Xavier-uniform) and a zero bias,
    drawn on ``device`` (default the card) from ``generator``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        from ..nn import initializer as I
        from ..nn.layer.common import param

        k = _pair(kernel_size)
        self._attrs = (stride, padding, dilation, deformable_groups, groups)
        self.weight = param([out_channels, in_channels // groups, k[0], k[1]],
                            weight_attr, I._default_weight_init(), device,
                            dtype, generator)
        self.bias = param([out_channels], bias_attr, I._default_bias_init(),
                          device, dtype, generator)

    def forward(self, x, offset, mask=None):
        stride, padding, dilation, dg, groups = self._attrs
        return deform_conv2d(x, offset, self.weight, self.bias, stride,
                             padding, dilation, dg, groups, mask)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """SSD box encode / decode (ref: ops.py box_coder)."""
    pb, pbv, tb = prior_box, prior_box_var, target_box
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(tw[:, None] / pw[None, :])
        dh = torch.log(th[:, None] / ph[None, :])
        out = torch.stack([dx, dy, dw, dh], -1)
        if pbv is not None:
            out = out / pbv[None, :, :]
        return out
    deltas = tb  # decode_center_size: [N, M, 4] deltas
    if pbv is not None:
        deltas = deltas * (pbv[None, :, :] if pbv.dim() == 2 else pbv)
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (v[None, :] for v in (pw, ph, pcx, pcy))
    else:
        pw_, ph_, pcx_, pcy_ = (v[:, None] for v in (pw, ph, pcx, pcy))
    cx = deltas[..., 0] * pw_ + pcx_
    cy = deltas[..., 1] * ph_ + pcy_
    bw = torch.exp(deltas[..., 2]) * pw_
    bh = torch.exp(deltas[..., 3]) * ph_
    return torch.stack([cx - bw * 0.5, cy - bh * 0.5,
                        cx + bw * 0.5 - norm, cy + bh * 0.5 - norm], -1)


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior anchors (ref: ops.py prior_box), built on the host and
    placed on ``input``'s device: ``(boxes, variances)`` ``[fh, fw, P,
    4]``."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    boxes = []
    for i in range(fh):
        for j in range(fw):
            cx = (j + offset) * step_w
            cy = (i + offset) * step_h
            for k, ms in enumerate(min_sizes):
                if min_max_aspect_ratios_order:
                    boxes.append((cx, cy, ms, ms))
                    if max_sizes:
                        sq = np.sqrt(ms * max_sizes[k])
                        boxes.append((cx, cy, sq, sq))
                    for ar in ars:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        boxes.append((cx, cy, ms * np.sqrt(ar),
                                      ms / np.sqrt(ar)))
                else:
                    for ar in ars:
                        boxes.append((cx, cy, ms * np.sqrt(ar),
                                      ms / np.sqrt(ar)))
                    if max_sizes:
                        sq = np.sqrt(ms * max_sizes[k])
                        boxes.append((cx, cy, sq, sq))
    arr = np.asarray(boxes, np.float32).reshape(fh, fw, -1, 4)
    out = np.stack([(arr[..., 0] - arr[..., 2] / 2) / iw,
                    (arr[..., 1] - arr[..., 3] / 2) / ih,
                    (arr[..., 0] + arr[..., 2] / 2) / iw,
                    (arr[..., 1] + arr[..., 3] / 2) / ih], -1)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape).copy()
    dev = input.device
    return torch.as_tensor(out, device=dev), torch.as_tensor(var, device=dev)


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode a YOLOv3 head (ref: ops.py yolo_box): ``(boxes [N, M, 4],
    scores [N, M, class_num])``, zero where the objectness is at most
    ``conf_thresh``."""
    na = len(anchors) // 2
    n, c, h, w = x.shape
    xa = x.reshape(n, na, -1, h, w)
    dev = x.device
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)
    sig = torch.sigmoid
    bx = (sig(xa[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
          + grid_x[None, None, None, :]) / w
    by = (sig(xa[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
          + grid_y[None, None, :, None]) / h
    aw = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    ah = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    in_w, in_h = w * downsample_ratio, h * downsample_ratio
    bw = torch.exp(xa[:, :, 2]) * aw / in_w
    bh = torch.exp(xa[:, :, 3]) * ah / in_h
    obj = sig(xa[:, :, 4])
    scores = obj[:, :, None] * sig(xa[:, :, 5:5 + class_num])
    imgs = img_size.to(torch.float32)
    ih = imgs[:, 0][:, None, None, None]
    iw = imgs[:, 1][:, None, None, None]
    x1, y1 = (bx - bw / 2) * iw, (by - bh / 2) * ih
    x2, y2 = (bx + bw / 2) * iw, (by + bh / 2) * ih
    if clip_bbox:
        x1 = torch.minimum(torch.clamp(x1, min=0), iw - 1)
        y1 = torch.minimum(torch.clamp(y1, min=0), ih - 1)
        x2 = torch.minimum(torch.clamp(x2, min=0), iw - 1)
        y2 = torch.minimum(torch.clamp(y2, min=0), ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
    scores = torch.movedim(scores, 2, -1).reshape(n, -1, class_num)
    keep = (obj.reshape(n, -1) > conf_thresh)[..., None]
    zero = torch.zeros((), dtype=boxes.dtype, device=dev)
    return torch.where(keep, boxes, zero), torch.where(keep, scores, zero)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss (ref: ops.py yolo_loss): coordinate,
    objectness and classification terms with each ground-truth box
    assigned to its best anchor; predictions of no object whose best IoU
    with a ground truth passes ``ignore_thresh`` are left out of the
    no-object term. A scalar, averaged over the batch."""
    na = len(anchor_mask)
    n, c, h, w = x.shape
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    pred = x.reshape(n, na, 5 + class_num, h, w)
    sig = torch.sigmoid
    in_w, in_h = w * downsample_ratio, h * downsample_ratio
    masked = [(anchors[2 * m], anchors[2 * m + 1]) for m in anchor_mask]
    aw = torch.tensor([a[0] for a in masked], **f32)
    ah = torch.tensor([a[1] for a in masked], **f32)
    all_aw = torch.tensor(anchors[0::2], **f32)
    all_ah = torch.tensor(anchors[1::2], **f32)
    gtb = gt_box
    gw, gh = gtb[:, :, 2], gtb[:, :, 3]
    inter = (torch.minimum(gw[:, :, None], all_aw[None, None, :] / in_w)
             * torch.minimum(gh[:, :, None], all_ah[None, None, :] / in_h))
    union = (gw[:, :, None] * gh[:, :, None]
             + (all_aw / in_w * all_ah / in_h)[None, None, :] - inter)
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), -1)  # [n, B]
    valid = (gw > 0) & (gh > 0)
    gi = torch.clamp((gtb[:, :, 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gtb[:, :, 1] * h).to(torch.int32), 0, h - 1).long()
    rows = torch.arange(n, device=dev)[:, None]
    obj_target = torch.zeros((n, na, h * w), **f32)
    loss = torch.zeros((), **f32)
    tgt = torch.nn.functional.one_hot(gt_label.long(), class_num).to(
        torch.float32)
    if use_label_smooth:
        delta = 1.0 / class_num
        tgt = tgt * (1 - delta) + delta / class_num
    for k in range(na):
        weight = (valid & (best == anchor_mask[k])).to(torch.float32)
        if gt_score is not None:
            weight = weight * gt_score
        tx = gtb[:, :, 0] * w - gi
        ty = gtb[:, :, 1] * h - gj
        tw = torch.log(torch.clamp(gw * in_w / aw[k], min=1e-9))
        th = torch.log(torch.clamp(gh * in_h / ah[k], min=1e-9))
        px = sig(pred[:, k, 0])[rows, gj, gi]
        py = sig(pred[:, k, 1])[rows, gj, gi]
        pw_ = pred[:, k, 2][rows, gj, gi]
        ph_ = pred[:, k, 3][rows, gj, gi]
        box_scale = 2.0 - gw * gh
        coord = ((px - tx) ** 2 + (py - ty) ** 2 + (pw_ - tw) ** 2
                 + (ph_ - th) ** 2)
        loss = loss + torch.sum(weight * box_scale * coord)
        obj_target[:, k] = obj_target[:, k].scatter_reduce(
            1, gj * w + gi, weight, "amax", include_self=True)
        pc = sig(pred[:, k, 5:])[rows, :, gj, gi]  # [n, B, class_num]
        bce = -(tgt * torch.log(torch.clamp(pc, 1e-9, 1))
                + (1 - tgt) * torch.log(torch.clamp(1 - pc, 1e-9, 1)))
        loss = loss + torch.sum(weight[..., None] * bce)
    obj_target = obj_target.reshape(n, na, h, w)
    grid_x = torch.arange(w, **f32)[None, None, None, :]
    grid_y = torch.arange(h, **f32)[None, None, :, None]
    pcx = (sig(pred[:, :, 0]) + grid_x) / w  # [n, na, h, w]
    pcy = (sig(pred[:, :, 1]) + grid_y) / h
    pww = torch.exp(pred[:, :, 2]) * aw[None, :, None, None] / in_w
    phh = torch.exp(pred[:, :, 3]) * ah[None, :, None, None] / in_h
    gcx = gtb[:, :, 0][:, None, None, None, :]  # [n, 1, 1, 1, B]
    gcy = gtb[:, :, 1][:, None, None, None, :]
    gww = gw[:, None, None, None, :]
    ghh = gh[:, None, None, None, :]
    lx = torch.maximum(pcx[..., None] - pww[..., None] / 2, gcx - gww / 2)
    rx = torch.minimum(pcx[..., None] + pww[..., None] / 2, gcx + gww / 2)
    ty_ = torch.maximum(pcy[..., None] - phh[..., None] / 2, gcy - ghh / 2)
    by_ = torch.minimum(pcy[..., None] + phh[..., None] / 2, gcy + ghh / 2)
    inter_ = torch.clamp(rx - lx, min=0) * torch.clamp(by_ - ty_, min=0)
    union_ = pww[..., None] * phh[..., None] + gww * ghh - inter_
    iou_all = torch.where(valid[:, None, None, None, :],
                          inter_ / torch.clamp(union_, min=1e-9),
                          torch.zeros((), **f32))
    best_iou = iou_all.amax(-1)  # [n, na, h, w]
    noobj_w = torch.where((obj_target == 0) & (best_iou > ignore_thresh),
                          0.0, 1.0)
    pobj = sig(pred[:, :, 4])
    obj_bce = -(obj_target * torch.log(torch.clamp(pobj, 1e-9, 1))
                + noobj_w * (1 - obj_target)
                * torch.log(torch.clamp(1 - pobj, 1e-9, 1)))
    return (loss + torch.sum(obj_bce)) / n


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Assign RoIs to FPN levels by scale (ref: ops.py
    distribute_fpn_proposals): ``(rois per level, restore index, rois_num
    per level or None)``, on the RoIs' device. Host-side restructuring."""
    dev = fpn_rois.device if isinstance(fpn_rois, torch.Tensor) else None
    rois = _host(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.maximum((rois[:, 2] - rois[:, 0] + off)
                               * (rois[:, 3] - rois[:, 1] + off), 0))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, order = [], []
    for level in range(min_level, max_level + 1):
        sel = np.nonzero(lvl == level)[0]
        outs.append(torch.as_tensor(rois[sel], device=dev))
        order.append(sel)
    restore = np.argsort(np.concatenate(order)).astype(np.int32)
    per = None
    if rois_num is not None:
        per = [torch.as_tensor(np.asarray([len(o)], np.int32), device=dev)
               for o in order]
    return outs, torch.as_tensor(restore, device=dev), per


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals (ref: ops.py generate_proposals): anchors decoded with
    the deltas, clipped, small boxes dropped, then :func:`nms`, per image.
    Host-driven (the output count depends on the data); results on the
    scores' device."""
    dev = scores.device if isinstance(scores, torch.Tensor) else None
    sc, bd, ims = _host(scores), _host(bbox_deltas), _host(img_size)
    an = _host(anchors).reshape(-1, 4)
    va = _host(variances).reshape(-1, 4)
    off = 1.0 if pixel_offset else 0.0
    out_rois, out_probs, out_nums = [], [], []
    for b in range(sc.shape[0]):
        s = sc[b].transpose(1, 2, 0).reshape(-1)
        d = bd[b].transpose(1, 2, 0).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d = s[order], d[order]
        a, v = an[order % len(an)], va[order % len(va)]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        bw = np.exp(np.minimum(v[:, 2] * d[:, 2], np.log(1000 / 16))) * aw
        bh = np.exp(np.minimum(v[:, 3] * d[:, 3], np.log(1000 / 16))) * ah
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - off,
                          cy + bh / 2 - off], -1)
        hh, ww = ims[b][0], ims[b][1]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, ww - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, hh - off)
        keep = ((boxes[:, 2] - boxes[:, 0] + off >= min_size)
                & (boxes[:, 3] - boxes[:, 1] + off >= min_size))
        boxes, s = boxes[keep], s[keep]
        if len(boxes):
            ki = nms(torch.as_tensor(boxes), nms_thresh, torch.as_tensor(s),
                     top_k=post_nms_top_n).numpy()
            boxes, s = boxes[ki], s[ki]
        out_rois.append(boxes)
        out_probs.append(s)
        out_nums.append(len(boxes))
    rois = torch.as_tensor(np.concatenate(out_rois) if out_rois
                           else np.zeros((0, 4), np.float32), device=dev)
    probs = torch.as_tensor(np.concatenate(out_probs) if out_probs
                            else np.zeros(0, np.float32), device=dev)
    if return_rois_num:
        return rois, probs, torch.as_tensor(np.asarray(out_nums, np.int32),
                                            device=dev)
    return rois, probs


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """SOLO matrix NMS (ref: ops.py matrix_nms): each score decayed by its
    worst IoU against higher-scored peers instead of hard suppression.
    Host-driven; results on the scores' device."""
    dev = scores.device if isinstance(scores, torch.Tensor) else None
    bb, sc = _host(bboxes), _host(scores)
    n, num_cls = sc.shape[0], sc.shape[1]
    outs, idxs, nums = [], [], []
    for b in range(n):
        dets = []
        for c in range(num_cls):
            if c == background_label:
                continue
            s = sc[b, c]
            sel = np.nonzero(s > score_threshold)[0]
            if not len(sel):
                continue
            order = sel[np.argsort(-s[sel])][:nms_top_k]
            boxes, ss = bb[b][order], s[order]
            x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
            y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
            x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
            y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            iou = inter / np.maximum(area[:, None] + area[None, :] - inter,
                                     1e-9)
            iou = np.triu(iou, 1)
            m = len(boxes)
            comp = np.array([iou[:j, j].max() if j else 0.0
                             for j in range(m)])
            if use_gaussian:
                pair = np.exp(-(iou ** 2 - comp[:, None] ** 2)
                              / gaussian_sigma)
            else:
                pair = (1 - iou) / np.maximum(1 - comp[:, None], 1e-9)
            pair = np.where(np.triu(np.ones((m, m), bool), 1), pair, np.inf)
            decay = np.minimum(pair.min(0), 1.0)
            ds = ss * decay
            for i in np.nonzero(ds > post_threshold)[0]:
                dets.append(([c, ds[i], *boxes[i]], order[i]))
        dets = sorted(dets, key=lambda r: -r[0][1])[:keep_top_k]
        outs.extend(d for d, _ in dets)
        nums.append(len(dets))
        idxs.extend(k for _, k in dets)
    out = torch.as_tensor(np.asarray(outs, np.float32).reshape(-1, 6),
                          device=dev)
    rois_num = torch.as_tensor(np.asarray(nums, np.int32), device=dev)
    index = torch.as_tensor(np.asarray(idxs, np.int32), device=dev)
    if return_index:
        return (out, index, rois_num) if return_rois_num else (out, index)
    return (out, rois_num) if return_rois_num else out


def read_file(filename, name=None):
    """ref: ops.py read_file — the file's bytes as a uint8 tensor (host)."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8).copy()
    return torch.from_numpy(data)


def decode_jpeg(x, mode="unchanged", name=None):
    """ref: ops.py decode_jpeg — ``[C, H, W]`` uint8 through PIL (a host
    decode; PIL is imported here, at the call)."""
    import io as _io

    from PIL import Image

    data = bytes(_host(x, np.uint8))
    img = Image.open(_io.BytesIO(data))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.array(arr))
