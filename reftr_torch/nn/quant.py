"""Int8 post-training quantization for serving (port of
reftr_tpu/nn/quant.py).

The backbone's bottleneck convolutions and the BERT and VL-transformer
projections and FFNs run as int8 products while everything around them
stays in the model's compute dtype:

    x -> quantize(x / s_in) -> int8 product -> int32
      -> * (w_scale[c] * s_in) (+ bias) -> compute dtype

Scales are static and symmetric: per output channel for weights (absmax /
127), per tensor for each product's input (absmax over calibration
batches). ``QuantConv`` and ``QuantDense`` hold the int8 weight
(``kernel_q``) and the float32 scales (``w_scale``, ``in_scale``, and the
dense's float32 ``bias``) as buffers and run the kernels of
``kernels/quant.py``. ``kernel_q`` is [Cout, K * K * Cin] in (kh, kw, c)
order for a conv (JAX's HWIO kernel transposed and flattened: the rows of
the implicit GEMM) and [Cout, Cin] for a dense; the JAX package's
float-stored kernels of the train prefix (``float_kernel``) are int8 here,
since buffers take no gradient either way.

Calibration. JAX's ``sow_absmax`` records each product's input absmax into
a "calib" collection. The port's counterpart is a recorder of forward
pre-hooks on the fp modules that the int8 twin replaces (``Calibrator``),
keyed by JAX's names, so that a calibration tree of the port and JAX's
``calib`` collection compare leaf by leaf: module path ``layer1.0.conv1``
records ``layer1_0/conv1_in``, ``layer.0.attention.q_proj``
``layer_0/attention/q_proj_in``, ``layers.2.ffn.linear1``
``layers_2/ffn/linear1_in``. The twin's quantized modules name the fp
modules to hook (``quant_targets``).

``quantize_params`` and its parts rewrite an fp state_dict (names of the
port) with a calibration tree into the int8 model's;
``calibrate_and_quantize`` (eval and serving) and
``calibrate_train_prefix`` (the frozen stem+layer1 in training) run the
batches. The model classes take the flags in ``nn/resnet.py``,
``nn/attention.py``, ``nn/bert.py``, ``nn/transformer.py`` and
``models/vl_transformer.py``; ``models/reftr.py`` sets one per scope.
"""

from __future__ import annotations

import dataclasses
import re
from contextlib import contextmanager
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from reftr_torch.kernels.quant import (QMAX, int8_conv, int8_dense,
                                      quantize_int8)

# conv names inside a Bottleneck; the stem (conv1 / conv1_s2d at the
# backbone's root) stays fp
_CONV_NAMES = ("conv1", "conv2", "conv3", "downsample_conv")
# Activation absmax beyond this means a broken fp model; a leaf outside
# (0, CEILING] would bake a nonsense in_scale into the int8 twin
CALIB_ABSMAX_CEILING = 1e6
# the scopes of quantize_int8 and the model attribute each covers
SCOPES = {"backbone": "img_backbone", "bert": "lang_backbone",
          "vl": "vl_transformer"}
_INDEX = re.compile(r"\.(\d+)(?=\.|$)")


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """The compute dtype of the product's output: autocast's where it is
    on (the eval step's), else the input's (a served model cast to its
    dtype), as JAX's ``.astype(self.dtype)``."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


class QuantConv(nn.Module):
    """Drop-in for the backbone's bias-free Conv2d on the int8 path, on
    NCHW views of channels-last memory (the backbone's layout): kernel_q
    int8 [Cout, k * k * Cin], w_scale float32 [Cout], in_scale float32 []."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.kernel_size = kernel
        self.stride = stride
        self.dilation = dilation
        self.register_buffer("kernel_q", torch.zeros(
            cout, kernel * kernel * cin, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(cout))
        self.register_buffer("in_scale", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        xq = quantize_int8(x.permute(0, 2, 3, 1), self.in_scale)
        y = int8_conv(xq, self.kernel_q, self.w_scale, self.in_scale, None,
                      k, self.stride, self.dilation, _out_dtype(x))
        return y.permute(0, 3, 1, 2)


class QuantDense(nn.Module):
    """Drop-in for nn.Linear on the int8 path: kernel_q int8 [out, in],
    w_scale float32 [out], in_scale float32 [], bias float32 [out] added
    after dequantization."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("kernel_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_features))
        self.register_buffer("in_scale", torch.ones(()))
        if use_bias:
            self.register_buffer("bias", torch.zeros(out_features))
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = quantize_int8(x, self.in_scale)
        return int8_dense(xq, self.kernel_q, self.w_scale, self.in_scale,
                          self.bias, _out_dtype(x))


def dense(in_features: int, out_features: int, quantize: bool) -> nn.Module:
    """nn.Linear, or its int8 twin under ``quantize``."""
    if quantize:
        return QuantDense(in_features, out_features)
    return nn.Linear(in_features, out_features)


QUANT_MODULES = (QuantConv, QuantDense)


def quantize_conv_kernel(weight: torch.Tensor, in_absmax: float
                         ) -> Dict[str, torch.Tensor]:
    """fp conv weight [Cout, Cin, kh, kw] + calibrated input absmax ->
    QuantConv buffers, as JAX's on its HWIO kernel: per output channel
    w_scale = max(absmax, 1e-12) / 127 in float32, kernel_q = clip(round(k
    / w_scale), -127, 127), in_scale = float32(max(absmax, 1e-12) / 127)."""
    k = weight.detach().float().permute(0, 2, 3, 1).reshape(
        weight.shape[0], -1)
    return _quantize_rows(k, in_absmax)


def quantize_dense_kernel(weight: torch.Tensor,
                          bias: Optional[torch.Tensor], in_absmax: float
                          ) -> Dict[str, torch.Tensor]:
    """fp Linear weight [out, in] (and bias) + calibrated input absmax ->
    QuantDense buffers (the bias stays float32)."""
    out = _quantize_rows(weight.detach().float(), in_absmax)
    if bias is not None:
        out["bias"] = bias.detach().float().clone()
    return out


def _quantize_rows(k: torch.Tensor, in_absmax: float
                   ) -> Dict[str, torch.Tensor]:
    """Per-row (output channel) int8 of float32 ``k`` [Cout, K]."""
    w_absmax = k.abs().amax(dim=1)
    w_scale = torch.clamp(w_absmax, min=1e-12) / QMAX
    kq = torch.clamp(torch.round(k / w_scale[:, None]), -QMAX, QMAX)
    in_scale = np.float32(max(float(in_absmax), 1e-12) / QMAX)
    return {"kernel_q": kq.to(torch.int8).contiguous(),
            "w_scale": w_scale,
            "in_scale": torch.tensor(in_scale, device=k.device)}


def calib_path(module_name: str) -> Tuple[str, ...]:
    """JAX's calib path of the input of the port's module ``module_name``:
    a numeric child joins its parent (``layer1.0`` -> ``layer1_0``) and the
    leaf is ``<name>_in``."""
    parts = _INDEX.sub(r"_\1", module_name).split(".")
    return tuple(parts[:-1]) + (f"{parts[-1]}_in",)


def calib_leaf(calib: Mapping, module_name: str):
    """The leaf of ``calib`` for the input of ``module_name``, or None."""
    node = calib
    for key in calib_path(module_name):
        if not isinstance(node, Mapping) or key not in node:
            return None
        node = node[key]
    return node


def _rewrite(out: Dict, module: str,
             qparams: Dict[str, torch.Tensor]) -> None:
    """Replace ``module``'s fp weight (and bias) in ``out`` by its int8
    buffers."""
    out.pop(f"{module}.weight")
    out.pop(f"{module}.bias", None)
    out.update({f"{module}.{name}": v for name, v in qparams.items()})


def _modules_with_weight(state_dict: Mapping[str, torch.Tensor]
                         ) -> List[str]:
    return [k[:-len(".weight")] for k in state_dict if k.endswith(".weight")]


def quantize_backbone_params(state_dict: Mapping[str, torch.Tensor],
                             calib: Mapping, stages=None
                             ) -> Dict[str, torch.Tensor]:
    """Rewrite a (fold_bn-folded) fp backbone state_dict (names relative to
    the ResNet) into its int8 twin's: the convs of the ``layer*``
    bottlenecks (all stages, or those in ``stages``) from their calibrated
    ``<conv>_in`` leaves; the stem and the folded FrozenBN biases pass
    through."""
    out = dict(state_dict)
    for module in _modules_with_weight(state_dict):
        parts = module.split(".")
        if not (len(parts) == 3 and parts[0].startswith("layer")
                and parts[2] in _CONV_NAMES):
            continue
        if stages is not None and int(parts[0][len("layer"):]) not in stages:
            continue
        absmax = float(np.max(np.asarray(calib_leaf(calib, module))))
        _rewrite(out, module, quantize_conv_kernel(
            state_dict[f"{module}.weight"], absmax))
    return out


def quantize_dense_params(state_dict: Mapping[str, torch.Tensor],
                          calib: Mapping) -> Dict[str, torch.Tensor]:
    """Rewrite every fp Linear of ``state_dict`` (names relative to the
    calib tree's root) that has a calibrated ``<name>_in`` leaf; the rest
    (LayerNorms, embeddings, BERT's pooler) passes through."""
    out = dict(state_dict)
    for module in _modules_with_weight(state_dict):
        leaf = calib_leaf(calib, module)
        if leaf is None or state_dict[f"{module}.weight"].dim() != 2:
            continue
        absmax = float(np.max(np.asarray(leaf)))
        _rewrite(out, module, quantize_dense_kernel(
            state_dict[f"{module}.weight"],
            state_dict.get(f"{module}.bias"), absmax))
    return out


def _sub(state_dict: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def _replace_sub(state_dict: Mapping[str, torch.Tensor], prefix: str,
                 sub: Mapping[str, torch.Tensor]) -> Dict:
    out = {k: v for k, v in state_dict.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in sub.items()})
    return out


def quantize_params(state_dict: Mapping[str, torch.Tensor], calib: Mapping,
                    scope=("backbone",)) -> Dict[str, torch.Tensor]:
    """fp -> int8 state_dict rewrite from a calibrated absmax tree, for the
    components named in ``scope`` ("backbone": the bottleneck convs;
    "bert" / "vl": every projection and FFN dense with a calibrated twin).
    Must match the model's ``ModelConfig.quantize_scope``."""
    out = dict(state_dict)
    if "backbone" in scope:
        out = _replace_sub(out, "img_backbone.", quantize_backbone_params(
            _sub(out, "img_backbone."), calib["img_backbone"]))
    for key in ("bert", "vl"):
        name = SCOPES[key]
        if key in scope and name in calib:
            out = _replace_sub(out, f"{name}.", quantize_dense_params(
                _sub(out, f"{name}."), calib[name]))
    return out


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def keystr(path: Tuple[str, ...]) -> str:
    """A path as JAX's ``keystr`` writes it: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def validate_calibration(calib: Mapping) -> None:
    """Every calibrated absmax must be finite, > 0 and at most the
    ceiling: a zero absmax (an input dead over all calibration batches)
    would quantize the whole tensor to 0, a NaN or inf poison every
    output."""
    bad = []
    for path, leaf in _leaves(calib):
        arr = np.asarray(leaf)
        mx = float(np.max(arr)) if arr.size else 0.0
        if (not np.isfinite(arr).all() or mx <= 0.0
                or mx > CALIB_ABSMAX_CEILING):
            bad.append((keystr(path), mx))
    if bad:
        raise ValueError(
            "int8 PTQ calibration produced invalid activation absmax "
            f"(must be finite, > 0, <= {CALIB_ABSMAX_CEILING:g}): {bad[:8]}")


def calibration_drift(calib: Mapping, observed: Mapping,
                      factor: float = 2.0) -> list:
    """Leaves where a later batch's absmax exceeds the calibrated one by
    more than ``factor``: inputs there saturate the int8 clip. Returns
    [(path, calibrated, observed), ...]."""
    drift = []
    for path, c in _leaves(calib):
        o = observed
        for key in path:
            o = o[key]
        cm = float(np.max(np.asarray(c)))
        om = float(np.max(np.asarray(o)))
        if om > factor * cm:
            drift.append((keystr(path), cm, om))
    return drift


def quant_targets(model_cls, cfg) -> List[str]:
    """The names of the modules that the int8 twin of ``cfg`` (its model
    class, built on the meta device) runs as QuantConv or QuantDense:
    the fp modules whose inputs calibration records."""
    with torch.device("meta"):
        twin = model_cls(cfg)
    return [name for name, mod in twin.named_modules()
            if isinstance(mod, QUANT_MODULES)]


class Calibrator:
    """Forward pre-hooks on ``model``'s modules ``names`` that keep each
    one's input absmax, max-reduced over the calls and batches run inside
    ``recording()``, on the device (no host sync until ``tree()``)."""

    def __init__(self, model: nn.Module, names: List[str]):
        self.model = model
        self.names = names
        self.absmax: Dict[str, torch.Tensor] = {}

    @contextmanager
    def recording(self) -> Iterator[None]:
        self.absmax = {}
        hooks = [self.model.get_submodule(name).register_forward_pre_hook(
            self._hook(name)) for name in self.names]
        try:
            yield
        finally:
            for h in hooks:
                h.remove()

    def _hook(self, name: str):
        def record(_module, args):
            m = args[0].detach().abs().amax().float()
            seen = self.absmax.get(name)
            self.absmax[name] = m if seen is None else torch.maximum(seen, m)
        return record

    def tree(self) -> Dict:
        """The recorded absmax as JAX's calib tree of float32 scalars."""
        out: Dict = {}
        for name, value in self.absmax.items():
            *parents, leaf = calib_path(name)
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = np.float32(value.item())
        return out


def _calibrate(model: nn.Module, names: List[str], loader, n_batches: int,
               device: torch.device, autocast: bool, probe: bool = False):
    """Run up to ``n_batches`` of ``loader`` through ``model`` in eval mode
    recording the inputs of ``names``: (absmax tree, under DDP the max
    over the ranks; batches run; with ``probe``, the next batch's tree, or
    None where the loader has no more)."""
    from reftr_torch.train.steps import to_device

    cal = Calibrator(model, names)
    dtype = getattr(model, "dtype", torch.float32)

    def run(batch) -> None:
        with torch.no_grad(), torch.autocast(
                device.type, dtype=dtype,
                enabled=autocast and dtype != torch.float32):
            model(to_device(batch, device))

    training = model.training
    model.eval()  # JAX's deterministic=True: no dropout, no seeds
    batches, n = iter(loader), 0
    with cal.recording():
        for batch, _targets in batches:
            run(batch)
            n += 1
            if n == n_batches:
                break
    if n == 0:
        raise ValueError("calibration loader yielded no batches")
    absmax = _max_over_ranks(cal.tree(), device)
    holdout = next(batches, None) if probe else None
    if holdout is not None:
        with cal.recording():
            run(holdout[0])
        holdout = cal.tree()
    model.train(training)
    return absmax, n, holdout


def _max_over_ranks(absmax: Dict, device: torch.device) -> Dict:
    """Under DDP, each leaf's max over the ranks (each calibrated on its
    own shard), so every rank bakes the same scales, as JAX's global
    batches and allgather give (reftr_tpu/nn/quant.py:396-401)."""
    from reftr_torch.core import distributed

    if not distributed.is_initialized():
        return absmax
    leaves = list(_leaves(absmax))
    vec = torch.tensor([float(v) for _, v in leaves], device=device)
    torch.distributed.all_reduce(vec, op=torch.distributed.ReduceOp.MAX)
    for (path, _), v in zip(leaves, vec.tolist()):
        node = absmax
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = np.float32(v)
    return absmax


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def calibrate_and_quantize(cfg, model: nn.Module, loader,
                           n_batches: int = 4, print_fn=print,
                           state_dict: Optional[Mapping] = None,
                           autocast: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """Eval-time PTQ: run ``n_batches`` of ``loader`` ((batch, targets)
    pairs of numpy arrays, like the eval loaders) through the fp
    ``model`` recording each product's input absmax (under DDP, the max
    over the ranks), and rewrite its
    weights for the int8 model of ``cfg`` (a RefTRConfig; its
    quantize_int8 on or off) at ``cfg.model.quantize_scope``. Returns that
    model's state_dict (``convert.build_model(..., state_dict=)``).

    ``state_dict`` gives the float32 weights to quantize where ``model``
    was cast to its compute dtype (``serve.serving_module``), as JAX
    quantizes its float32 params; by default ``model``'s own. ``autocast``
    runs the batches under the eval step's autocast. The first batch past
    ``n_batches`` probes drift (``calibration_drift``), as in JAX."""
    from reftr_torch.convert import model_class

    mc = dataclasses.replace(cfg.model, quantize_int8=True,
                             quantize_train_prefix=False)
    names = quant_targets(model_class(mc), mc)
    absmax, n, holdout = _calibrate(model, names, loader, n_batches,
                                    _model_device(model), autocast,
                                    probe=True)
    validate_calibration(absmax)
    if holdout is not None:
        for path, cm, om in calibration_drift(absmax, holdout)[:8]:
            print_fn(f"int8 PTQ WARNING: activation absmax drift at {path}: "
                     f"calibrated {cm:.3g}, observed {om:.3g} (> 2x): "
                     "inputs saturate the int8 clip; recalibrate with more "
                     "batches or widen quant_calib_batches")
    print_fn(f"int8 PTQ: calibrated on {n} batches; quantizing "
             f"{', '.join(cfg.model.quantize_scope)}")
    weights = model.state_dict() if state_dict is None else state_dict
    return quantize_params(weights, absmax, scope=cfg.model.quantize_scope)


def calibrate_train_prefix(cfg, model: nn.Module, loader,
                           n_batches: int = 4, print_fn=print
                           ) -> Dict[str, torch.Tensor]:
    """Training-time int8 of the frozen stem+layer1 prefix
    (``quantize_train_prefix``): calibrate layer1's conv inputs on the
    first ``n_batches`` train batches through the fp ``model`` (float32
    weights, the train step's autocast), then rewrite layer1's bottleneck
    convs to int8. Returns the state_dict of the model with
    ``quantize_train_prefix``. Legal because the prefix is frozen: no
    gradient reaches the int8 products. Under DDP every rank's absmax is
    max-reduced, so every rank bakes the same scales. The drift probe of
    ``calibrate_and_quantize`` is not run, as in JAX."""
    names = [f"img_backbone.layer1.{b}.{conv}"
             for b in range(len(model.img_backbone.layer1))
             for conv in _CONV_NAMES
             if isinstance(getattr(model.img_backbone.layer1[b], conv, None),
                           nn.Conv2d)]
    dev = _model_device(model)
    absmax, _, _ = _calibrate(model, names, loader, n_batches, dev,
                              autocast=True)
    validate_calibration(absmax)
    print_fn(f"int8 train-prefix: calibrated layer1 on {n_batches} "
             "batches; rewriting to int8")
    sd = model.state_dict()
    return _replace_sub(sd, "img_backbone.", quantize_backbone_params(
        _sub(sd, "img_backbone."), absmax["img_backbone"], stages={1}))
