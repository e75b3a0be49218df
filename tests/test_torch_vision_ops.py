"""Port parity: ``paddle_tpu_torch.vision.ops`` against the JAX package's
``vision.ops`` on the same numpy inputs made from a seed, in f32.

- ``nms``: kept indices equal (plain, per category, ``top_k``) over
  hundreds of overlapping boxes with distinct scores; ``box_iou`` and
  ``box_area`` to ``ATOL``;
- ``roi_align`` / ``roi_pool`` over several images' boxes, and the layers,
  values to ``ATOL`` and ``roi_align``'s input gradient; ``psroi_pool``;
- ``deform_conv2d`` with offsets, a modulation mask, groups and
  deformable groups (and the gradients of its inputs and weight), and
  ``DeformConv2D``'s parameters;
- ``box_coder`` both ways, ``prior_box``, ``yolo_box``, ``yolo_loss``,
  ``distribute_fpn_proposals``, ``generate_proposals``, ``matrix_nms``,
  ``read_file`` and ``decode_jpeg``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops

ATOL = 1e-5


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


def _boxes(n, seed=0, span=100.0, size=30.0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * span
    wh = rng.rand(n, 2) * size + 1.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _both(fn, *arrays, **kw):
    j = getattr(jops, fn)(*[paddle.to_tensor(a) if isinstance(a, np.ndarray)
                            else a for a in arrays], **kw)
    t = getattr(tops, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in arrays], **kw)
    return j, t


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("kind", ["plain", "categories", "top_k",
                                  "no_scores"])
def test_nms_keeps_the_references_indices(thr, kind):
    b = _boxes(400, seed=1)
    s = np.random.RandomState(2).permutation(400).astype(np.float32) / 400
    kw = {}
    args = (b, thr) if kind == "no_scores" else (b, thr, s)
    if kind == "categories":
        cats = np.random.RandomState(3).randint(0, 4, 400).astype(np.int64)
        kw = dict(category_idxs=cats, categories=[0, 1, 2, 3])
    if kind == "top_k":
        kw = dict(top_k=17)
    j, t = _both("nms", *args, **kw)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), _np(j))


def test_nms_of_no_boxes():
    assert tops.nms(torch.zeros((0, 4))).shape == (0,)


def test_box_iou_and_area():
    a, b = _boxes(7, seed=4), _boxes(5, seed=5)
    j, t = _both("box_iou", a, b)
    np.testing.assert_allclose(t.numpy(), _np(j), atol=ATOL)
    j, t = _both("box_area", a)
    np.testing.assert_allclose(t.numpy(), _np(j), atol=1e-3)


def _rois(seed=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 16, 20).astype(np.float32)
    boxes = np.concatenate([_boxes(3, seed, 10.0, 8.0),
                            _boxes(2, seed + 1, 12.0, 6.0)])
    return x, boxes, np.array([3, 2], np.int64)


@pytest.mark.parametrize("fn", ["roi_align", "roi_pool"])
@pytest.mark.parametrize("size,scale", [(4, 1.0), ((3, 5), 0.5)])
def test_roi_ops_match(fn, size, scale):
    x, boxes, num = _rois()
    xj = paddle.to_tensor(x, stop_gradient=False)
    j = getattr(jops, fn)(xj, paddle.to_tensor(boxes), paddle.to_tensor(num),
                          output_size=size, spatial_scale=scale)
    xt = torch.tensor(x, requires_grad=True)
    t = getattr(tops, fn)(xt, torch.from_numpy(boxes), torch.from_numpy(num),
                          output_size=size, spatial_scale=scale)
    np.testing.assert_allclose(t.detach().numpy(), _np(j), atol=ATOL)
    if fn == "roi_align":
        w = np.random.RandomState(9).randn(*t.shape).astype(np.float32)
        (j * paddle.to_tensor(w)).sum().backward()
        (t * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), _np(xj.grad), atol=ATOL)


@pytest.mark.parametrize("layer", ["RoIAlign", "RoIPool", "PSRoIPool"])
def test_roi_layers_match(layer):
    x, boxes, num = _rois(7)
    if layer == "PSRoIPool":
        x = np.random.RandomState(8).randn(2, 2 * 9, 16, 20).astype(
            np.float32)
    j = getattr(jops, layer)(3, 0.75)(paddle.to_tensor(x),
                                      paddle.to_tensor(boxes),
                                      paddle.to_tensor(num))
    t = getattr(tops, layer)(3, 0.75)(torch.from_numpy(x),
                                      torch.from_numpy(boxes),
                                      torch.from_numpy(num))
    np.testing.assert_allclose(t.numpy(), _np(j), atol=ATOL)


@pytest.mark.parametrize("groups,dg,with_mask,stride,pad,dil", [
    (1, 1, False, 1, 1, 1), (2, 2, True, 2, 1, 1), (1, 2, True, 1, 2, 2)])
def test_deform_conv2d_and_its_gradients(groups, dg, with_mask, stride, pad,
                                         dil):
    rng = np.random.RandomState(10)
    n, c, h, w, co, k = 2, 4, 9, 8, 6, 3
    oh = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    ow = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    arrays = dict(
        x=rng.randn(n, c, h, w).astype(np.float32),
        offset=(rng.randn(n, 2 * dg * k * k, oh, ow) * 1.5).astype(
            np.float32),
        weight=rng.randn(co, c // groups, k, k).astype(np.float32) * 0.3,
        bias=rng.randn(co).astype(np.float32))
    if with_mask:
        arrays["mask"] = rng.rand(n, dg * k * k, oh, ow).astype(np.float32)
    kw = dict(stride=stride, padding=pad, dilation=dil, deformable_groups=dg,
              groups=groups)
    jt = {k_: paddle.to_tensor(v, stop_gradient=False)
          for k_, v in arrays.items()}
    tt = {k_: torch.tensor(v, requires_grad=True) for k_, v in arrays.items()}
    j = jops.deform_conv2d(**jt, **kw)
    t = tops.deform_conv2d(**tt, **kw)
    np.testing.assert_allclose(t.detach().numpy(), _np(j), atol=1e-4)
    g = rng.randn(*t.shape).astype(np.float32)
    (j * paddle.to_tensor(g)).sum().backward()
    (t * torch.from_numpy(g)).sum().backward()
    for k_ in arrays:
        np.testing.assert_allclose(tt[k_].grad.numpy(), _np(jt[k_].grad),
                                   atol=1e-3, err_msg=k_)


def test_deform_conv_layer_parameters():
    j = jops.DeformConv2D(4, 6, 3, groups=2)
    t = tops.DeformConv2D(4, 6, 3, groups=2, device="cpu")
    assert {n: tuple(p.shape) for n, p in t.named_parameters()} == {
        n: tuple(p.shape) for n, p in j.named_parameters()}
    from paddle_tpu_torch.utils import load_jax_params

    load_jax_params(t, {n: _np(p) for n, p in j.named_parameters()})
    rng = np.random.RandomState(11)
    x = rng.randn(1, 4, 7, 7).astype(np.float32)
    off = rng.randn(1, 18, 5, 5).astype(np.float32)
    np.testing.assert_allclose(
        t(torch.from_numpy(x), torch.from_numpy(off)).detach().numpy(),
        _np(j(paddle.to_tensor(x), paddle.to_tensor(off))), atol=1e-4)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("with_var", [True, False])
def test_box_coder_both_ways(normalized, with_var):
    prior = _boxes(5, 12, 1.0, 0.5)
    var = np.full((5, 4), 0.2, np.float32) if with_var else None
    target = _boxes(3, 13, 1.0, 0.5)
    j, t = _both("box_coder", prior, var, target,
                 code_type="encode_center_size", box_normalized=normalized)
    np.testing.assert_allclose(t.numpy(), _np(j), atol=ATOL)
    deltas = (np.random.RandomState(14).randn(3, 5, 4) * 0.1).astype(
        np.float32)
    for axis in (0, 1):
        pr = prior if axis == 0 else prior[:3]
        vv = var if var is None or axis == 0 else var[:3]
        dd = deltas if axis == 0 else deltas[:, :3]
        j, t = _both("box_coder", pr, vv, dd, code_type="decode_center_size",
                     box_normalized=normalized, axis=axis)
        np.testing.assert_allclose(t.numpy(), _np(j), atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[4.0], aspect_ratios=[2.0], flip=True, clip=True),
    dict(min_sizes=[4.0, 8.0], max_sizes=[8.0, 12.0], aspect_ratios=[0.5],
         min_max_aspect_ratios_order=True, steps=(4.0, 4.0))])
def test_prior_box(kw):
    feat = np.zeros((1, 2, 5, 6), np.float32)
    img = np.zeros((1, 3, 20, 24), np.float32)
    j, t = _both("prior_box", feat, img, **kw)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL)


def test_yolo_box():
    rng = np.random.RandomState(15)
    anchors = [10, 13, 16, 30, 33, 23]
    x = rng.randn(2, 3 * (5 + 4), 5, 6).astype(np.float32)
    img = np.array([[40, 48], [36, 30]], np.int32)
    j, t = _both("yolo_box", x, img, anchors=anchors, class_num=4,
                 conf_thresh=0.4, downsample_ratio=8, scale_x_y=1.05)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4)


@pytest.mark.parametrize("smooth,score", [(True, False), (False, True)])
def test_yolo_loss_and_its_gradient(smooth, score):
    rng = np.random.RandomState(16)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    x = rng.randn(2, 3 * (5 + 3), 6, 6).astype(np.float32)
    gt = np.concatenate([rng.rand(2, 4, 2) * 0.8 + 0.1,
                         rng.rand(2, 4, 2) * 0.4 + 0.05], -1).astype(
        np.float32)
    gt[1, 3] = 0.0  # an empty slot
    label = rng.randint(0, 3, (2, 4)).astype(np.int64)
    extra = dict(gt_score=rng.rand(2, 4).astype(np.float32)) if score else {}
    kw = dict(anchors=anchors, anchor_mask=[0, 1, 2], class_num=3,
              ignore_thresh=0.5, downsample_ratio=8, use_label_smooth=smooth)
    xj = paddle.to_tensor(x, stop_gradient=False)
    j = jops.yolo_loss(xj, paddle.to_tensor(gt), paddle.to_tensor(label),
                       **{k: paddle.to_tensor(v) for k, v in extra.items()},
                       **kw)
    xt = torch.tensor(x, requires_grad=True)
    t = tops.yolo_loss(xt, torch.from_numpy(gt), torch.from_numpy(label),
                       **{k: torch.from_numpy(v) for k, v in extra.items()},
                       **kw)
    np.testing.assert_allclose(float(t.detach()), float(_np(j)), rtol=1e-5)
    j.backward()
    t.backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(xj.grad), atol=1e-5)


def test_distribute_fpn_proposals():
    rois = _boxes(40, 17, 200.0, 150.0)
    j, t = _both("distribute_fpn_proposals", rois, min_level=2, max_level=5,
                 refer_level=4, refer_scale=64, rois_num=np.array([40]))
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(t[1].numpy(), _np(j[1]))
    assert [int(a.numpy()[0]) for a in t[2]] == [int(_np(b)[0]) for b in j[2]]


def test_generate_proposals():
    rng = np.random.RandomState(18)
    a, h, w = 3, 6, 7
    scores = rng.rand(2, a, h, w).astype(np.float32)
    deltas = (rng.randn(2, 4 * a, h, w) * 0.2).astype(np.float32)
    anchors = _boxes(h * w * a, 19, 60.0, 20.0).reshape(h, w, a, 4)
    var = np.ones((h, w, a, 4), np.float32)
    img = np.array([[64, 72], [60, 70]], np.float32)
    j, t = _both("generate_proposals", scores, deltas, img, anchors, var,
                 pre_nms_top_n=80, post_nms_top_n=20, nms_thresh=0.5,
                 min_size=2.0, return_rois_num=True)
    for a_, b_ in zip(t, j):
        np.testing.assert_allclose(a_.numpy(), _np(b_), atol=1e-4)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rng = np.random.RandomState(20)
    boxes = np.stack([_boxes(30, 21 + i, 1.0, 0.4) for i in range(2)])
    scores = rng.rand(2, 3, 30).astype(np.float32)
    j, t = _both("matrix_nms", boxes, scores, score_threshold=0.3,
                 post_threshold=0.2, nms_top_k=20, keep_top_k=25,
                 use_gaussian=gaussian, return_index=True)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL)


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image

    img = np.random.RandomState(22).randint(0, 256, (12, 10, 3), np.uint8)
    path = tmp_path / "x.jpg"
    Image.fromarray(img).save(path)
    jd, td = jops.read_file(str(path)), tops.read_file(str(path))
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    for mode in ("unchanged", "gray", "rgb"):
        np.testing.assert_array_equal(tops.decode_jpeg(td, mode).numpy(),
                                      _np(jops.decode_jpeg(jd, mode)))


def test_every_reference_op_has_a_counterpart():
    import inspect

    names = [n for n, v in vars(jops).items() if not n.startswith("_")
             and (inspect.isfunction(v) or inspect.isclass(v))
             and getattr(v, "__module__", "") == jops.__name__]
    assert len(names) >= 20
    assert [n for n in names if not hasattr(tops, n)] == []
