"""Load-time reparameterisations of the backbone's weights (port of
reftr_tpu/nn/fold.py), on the port's state_dict names and its OIHW
convolution kernels.

  * space-to-depth stem (``fold_conv1_to_s2d``): the 7x7/stride-2 stem
    conv on 3 channels becomes an exactly equivalent 4x4/stride-1 conv
    on the 12 channels of the input's 2x2 space-to-depth, channel order
    (s, t, c) (``nn/resnet.py::space_to_depth``).
  * FrozenBN folding (``_fold_pair``): FrozenBatchNorm is the affine
    y = x * scale + shift with constant scale and shift; scale folds into
    the preceding conv's output channels, leaving a bias add.
  * normalisation folding (``fold_normalize_into_stem``): /255 and the
    ImageNet mean/std fold into the stem's kernel and bn1's bias, so the
    model takes uint8 canvases cast to its compute dtype.
  * inner-width padding (``pad_inner_channels``) and layer1 on the 2x2
    space-to-depth grid (``fold_layer1_to_block``), channel order
    (py, px, c).

The arithmetic is the JAX package's: scales and shifts in float64, the
kernels multiplied in float32 and stored float32, so that a tree folded
here equals JAX's fold carried through ``convert.from_flax``.

Derivation of the stem fold: with x padded by 3, O[i,j] =
sum_{u,v<7} W[u,v] x[2i+u-3, 2j+v-3]. Pad W to 8x8 at the top-left and x
by 4; substituting u = 2a+s gives O[i,j] =
sum_{a,b<4, s,t<2} W8[2a+s,2b+t] Y[i+a, j+b, s, t] where Y is the 2x2
space-to-depth of the padded input: a 4x4 VALID conv whose extra last
output row and column (from the larger padding) are sliced off.

``fold_normalize`` is exact for every output whose taps lie inside the
canvas; on the outermost output ring the stem's zero padding taps change
meaning from "black pixels" (normalize(0)) to "zero in normalised space",
which is the reference's padding of the normalised tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from reftr_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

_BN_EPS = 1e-5
_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
          ("downsample_conv", "downsample_bn"), ("conv1_s2d", "bn1"))
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
BACKBONE = "img_backbone."

Tree = Dict[str, Dict[str, np.ndarray]]


def fold_conv1_to_s2d(kernel: np.ndarray) -> np.ndarray:
    """[O, C, 7, 7] stride-2 stem kernel -> [O, 4C, 4, 4] for the s2d stem,
    input channel order (s, t, c)."""
    o, c, kh, kw = kernel.shape
    assert (kh, kw) == (7, 7), f"stem kernel must be 7x7, got {kernel.shape}"
    w8 = np.pad(np.asarray(kernel), ((0, 0), (0, 0), (1, 0), (1, 0)))
    # u = 2a+s, v = 2b+t: [O, C, a, s, b, t] -> [O, s, t, C, a, b]
    k = w8.reshape(o, c, 4, 2, 4, 2).transpose(0, 3, 5, 1, 2, 4)
    return np.ascontiguousarray(k.reshape(o, 4 * c, 4, 4))


def _fold_pair(kernel: np.ndarray, bn: Mapping[str, np.ndarray],
               eps: float = _BN_EPS):
    """(folded OIHW kernel, {"bias": shift}) of a conv and its FrozenBN."""
    w = np.asarray(bn["weight"], np.float64)
    var = np.asarray(bn["running_var"], np.float64)
    mean = np.asarray(bn["running_mean"], np.float64)
    bias = np.asarray(bn["bias"], np.float64)
    scale = w / np.sqrt(var + eps)
    shift = bias - mean * scale
    kernel = np.asarray(kernel, np.float32)
    folded = (kernel * scale.astype(np.float32)[:, None, None, None]
              ).astype(np.float32)
    return folded, {"bias": shift.astype(np.float32)}


def fold_normalize_into_stem(tree: Tree) -> Tree:
    """Fold the uint8 input normalisation (/255, ImageNet mean and std)
    into the BN-folded stem: with n = a*x + b per channel (a_c =
    1/(255 std_c), b_c = -mean_c/std_c), conv(W, n) = conv(W*a, x) +
    sum_taps(W)*b, the scale into the stem kernel's input channels and the
    constant into bn1's bias. Requires fold_bn (bn1 bias-only)."""
    out = {k: dict(v) for k, v in tree.items()}
    cname = "conv1_s2d" if "conv1_s2d" in out else "conv1"
    assert "bias" in out["bn1"] and "weight" not in out["bn1"], (
        "fold_normalize requires fold_bn (bias-only bn1)")
    kernel = np.asarray(out[cname]["weight"], np.float64)  # [O, cin, kh, kw]
    cin = kernel.shape[1]
    assert cin % 3 == 0, cin
    mean = np.asarray(IMAGENET_MEAN, np.float64)
    std = np.asarray(IMAGENET_STD, np.float64)
    a = np.tile(1.0 / (255.0 * std), cin // 3)  # channel order (s, t, rgb)
    b = np.tile(-mean / std, cin // 3)
    bias_add = np.einsum("ocuv,c->o", kernel, b)
    out[cname] = {"weight": (kernel * a[None, :, None, None]).astype(
        np.float32)}
    out["bn1"] = {"bias": (np.asarray(out["bn1"]["bias"], np.float64)
                           + bias_add).astype(np.float32)}
    return out


def _pad_axis(arr: np.ndarray, axis: int, to: int,
              value: float = 0.0) -> np.ndarray:
    n = arr.shape[axis]
    if n >= to:
        return np.asarray(arr)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, to - n)
    return np.pad(np.asarray(arr), pad, constant_values=value)


def pad_inner_channels(tree: Tree, min_width: int) -> Tree:
    """Zero-pad every bottleneck's inner channels (conv1's output, conv2,
    conv3's input) up to ``min_width``: the weights of
    ResNet(min_inner_width=min_width). Exact: padded outputs carry zeros
    (zero kernel rows; an unfolded FrozenBN is the identity there) and
    conv3's padded inputs have zero weights."""
    out = {k: dict(v) for k, v in tree.items()}
    for name in list(out):
        if not name.startswith("layer") or name.count(".") != 1:
            continue
        mod = out[name]
        if "conv2.weight" not in mod:
            continue
        if mod["conv2.weight"].shape[1] >= min_width:
            continue
        mod["conv1.weight"] = _pad_axis(mod["conv1.weight"], 0, min_width)
        mod["conv2.weight"] = _pad_axis(_pad_axis(
            mod["conv2.weight"], 0, min_width), 1, min_width)
        mod["conv3.weight"] = _pad_axis(mod["conv3.weight"], 1, min_width)
        for bname in ("bn1", "bn2"):
            for leaf, fill in (("bias", 0.0), ("weight", 1.0),
                               ("running_mean", 0.0), ("running_var", 1.0)):
                key = f"{bname}.{leaf}"
                if key in mod:
                    mod[key] = _pad_axis(mod[key], 0, min_width, fill)
    return out


def fold_1x1_to_block(kernel: np.ndarray) -> np.ndarray:
    """[cout, cin, 1, 1] -> [4cout, 4cin, 1, 1], block-diagonal per 2x2
    subpixel: W'[(q,o),(p,c)] = W[o,c] * delta(p=q), channel order
    (py, px, c). Exact."""
    cout, cin = kernel.shape[:2]
    w = np.asarray(kernel, np.float32)
    k = np.zeros((4 * cout, 4 * cin, 1, 1), np.float32)
    for p in range(4):
        k[p * cout:(p + 1) * cout, p * cin:(p + 1) * cin] = w
    return k


def fold_3x3_to_block(kernel: np.ndarray) -> np.ndarray:
    """[cout, cin, 3, 3] stride-1 kernel -> [4cout, 4cin, 3, 3] on the 2x2
    block grid (stride 1, padding 1). Exact.

    Output subpixel (qy,qx) of block (Y,X) is pixel (2Y+qy, 2X+qx); its tap
    at offset (dy,dx) reads block offset (floor((qy+dy)/2),
    floor((qx+dx)/2)), subpixel ((qy+dy)%2, (qx+dx)%2). The offsets stay in
    [-1, 1], so a 3x3 block kernel (three quarters zeros) holds the conv,
    and its zero taps absorb the block grid's padding."""
    cout, cin = kernel.shape[:2]
    w = np.asarray(kernel, np.float32)
    k = np.zeros((4 * cout, 4 * cin, 3, 3), np.float32)
    for qy in range(2):
        for qx in range(2):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    by, py = divmod(qy + dy, 2)
                    bx, px = divmod(qx + dx, 2)
                    pi = (py * 2 + px) * cin
                    qi = (qy * 2 + qx) * cout
                    k[qi:qi + cout, pi:pi + cin, by + 1, bx + 1] = \
                        w[:, :, dy + 1, dx + 1]
    return k


def fold_layer1_to_block(tree: Tree) -> Tree:
    """Rewrite every layer1 bottleneck for ResNet(block_layer1): its
    kernels on the 2x2 block grid, its per-channel vectors (FrozenBN's
    tensors or folded biases) tiled x4 in (py, px, c) order."""
    out = dict(tree)
    for name, mod in tree.items():
        if not name.startswith("layer1."):
            continue
        m = {}
        for key, value in mod.items():
            module = key.rsplit(".", 1)[0]
            if module in ("conv1", "conv3", "downsample_conv"):
                m[key] = fold_1x1_to_block(value)
            elif module == "conv2":
                m[key] = fold_3x3_to_block(value)
            else:
                m[key] = np.tile(np.asarray(value), 4)
        out[name] = m
    return out


def _split(state: Mapping[str, Any]) -> Tree:
    """A backbone state_dict (names relative to the ResNet) -> {"conv1":
    {"weight": ...}, "bn1": {...}, "layer1.0": {"conv1.weight": ...}}: the
    stem's modules, and each bottleneck's tensors under its block."""
    tree: Tree = {}
    for key, value in state.items():
        arr = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value))
        parts = key.split(".")
        if parts[0].startswith("layer"):
            block, leaf = ".".join(parts[:2]), ".".join(parts[2:])
        else:
            block, leaf = ".".join(parts[:-1]), parts[-1]
        tree.setdefault(block, {})[leaf] = arr
    return tree


def _join(tree: Tree) -> Dict[str, np.ndarray]:
    return {f"{block}.{leaf}": v for block, mod in tree.items()
            for leaf, v in mod.items()}


def _fold_block_pairs(mod: Dict[str, np.ndarray], eps: float) -> None:
    for cname, bname in _PAIRS:
        ckey = f"{cname}.weight"
        if ckey in mod and f"{bname}.weight" in mod:
            bn = {leaf: mod.pop(f"{bname}.{leaf}") for leaf in _BN_LEAVES}
            mod[ckey], folded = _fold_pair(mod[ckey], bn, eps)
            mod[f"{bname}.bias"] = folded["bias"]


def optimize_resnet_params(
    state: Mapping[str, Any],
    space_to_depth: bool = False,
    fold_bn: bool = False,
    fold_normalize: bool = False,
    min_inner_width: int = 0,
    block_layer1: bool = False,
    eps: float = _BN_EPS,
) -> Dict[str, np.ndarray]:
    """A standard ResNet's state_dict (names relative to the ResNet:
    ``conv1.weight``, ``bn1.running_var``, ``layer1.0.conv2.weight``, ...)
    -> the float32 state_dict of ResNet(space_to_depth, fold_bn,
    min_inner_width, block_layer1) that computes the same function (with
    ``fold_normalize``, on uint8 input).

    Order matters, as in the JAX package: the stem kernel is rearranged
    first, then BN scales fold into whichever stem conv exists, then the
    input normalisation folds into the result, then the padding or the
    block rewrite."""
    tree = _split(state)
    if space_to_depth and "conv1" in tree:
        tree["conv1_s2d"] = {"weight": fold_conv1_to_s2d(
            tree.pop("conv1")["weight"])}
    if fold_bn:
        for name, mod in tree.items():
            if name.startswith("layer"):
                _fold_block_pairs(mod, eps)
        for cname in ("conv1", "conv1_s2d"):
            if cname in tree and "weight" in tree.get("bn1", {}):
                tree[cname]["weight"], tree["bn1"] = _fold_pair(
                    tree[cname]["weight"], tree["bn1"], eps)
    if fold_normalize:
        tree = fold_normalize_into_stem(tree)
    if min_inner_width:
        assert not block_layer1, \
            "backbone_pad_width and block_layer1 are mutually exclusive"
        tree = pad_inner_channels(tree, min_inner_width)
    if block_layer1:
        tree = fold_layer1_to_block(tree)
    return {k: np.ascontiguousarray(v, np.float32)
            for k, v in _join(tree).items()}


def folds_backbone(model_cfg) -> bool:
    """Whether ``model_cfg`` asks for any of the backbone's
    reparameterisations."""
    return bool(model_cfg.space_to_depth_stem or model_cfg.fold_bn
                or model_cfg.fold_normalize or model_cfg.backbone_pad_width
                or model_cfg.block_layer1)


def optimize_backbone_in_tree(state: Mapping[str, Any], model_cfg
                              ) -> Dict[str, Any]:
    """Apply ``model_cfg``'s backbone reparameterisations to the
    ``img_backbone.*`` tensors of a whole model's state_dict (a converted
    reference checkpoint, or a seeded init, both standard); the rest is
    returned as it is. Folded tensors come back as float32 CPU tensors."""
    if not folds_backbone(model_cfg):
        return dict(state)
    out = {k: v for k, v in state.items() if not k.startswith(BACKBONE)}
    backbone = {k[len(BACKBONE):]: v for k, v in state.items()
                if k.startswith(BACKBONE)}
    if backbone:
        folded = optimize_resnet_params(
            backbone, space_to_depth=model_cfg.space_to_depth_stem,
            fold_bn=model_cfg.fold_bn,
            fold_normalize=model_cfg.fold_normalize,
            min_inner_width=model_cfg.backbone_pad_width,
            block_layer1=model_cfg.block_layer1)
        out.update({BACKBONE + k: torch.from_numpy(v)
                    for k, v in folded.items()})
    return out
